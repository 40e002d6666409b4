"""Quickstart on the PyTorch port: the paper's study in a minute.

Trains logistic regression on a synthetic covtype-like dataset with the
three SGD strategies the paper compares — sequential, synchronous parallel,
and asynchronous replica-merge (Hogwild-family) — and prints the three
performance axes for each: hardware efficiency (time/epoch), statistical
efficiency (epochs to 1% error) and time to convergence.  The twin of
``examples/quickstart.py``; runs on ``cuda`` (the port's kernels) unless
``--device`` says otherwise.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --max-n 256 --epochs 3
"""
import argparse

from repro_torch.core import convergence, glm, sgd
from repro_torch.data import synthetic
from repro_torch.kernels import common


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-n", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = common.device(args.device)

    ds = synthetic.paper_dataset("covtype", max_n=args.max_n, device=dev)
    X, y = ds.X, ds.y

    strategies = {
        "sequential (B=1)": (sgd.AsyncLocalSGD(replicas=1, local_batch=1),
                             1e-2),
        "synchronous (batch)": (sgd.SyncSGD(), 1e-3),
        "async 8 replicas": (sgd.AsyncLocalSGD(replicas=8, local_batch=1),
                             1e-2),
        "async 8 replicas rep-5": (sgd.AsyncLocalSGD(replicas=8,
                                                     local_batch=1, rep_k=5),
                                   1e-2),
    }

    runs = {}
    for name, (strat, step) in strategies.items():
        prob = glm.GLMProblem("lr", X, y, step)
        runs[name] = sgd.run(prob, strat, epochs=args.epochs)

    optimal = convergence.optimal_loss(runs.values())
    target = optimal * 1.01
    print(f"optimal loss seen: {optimal:.4f}  (1% target {target:.4f}) "
          f"on {dev}\n")
    print(f"{'strategy':26s} {'ms/epoch':>9s} {'epochs→1%':>10s} "
          f"{'time→1% (s)':>12s}  final loss")
    for name, r in runs.items():
        e = r.epochs_to(target)
        t = r.time_to(target)
        print(f"{name:26s} {1e3*r.time_per_epoch:9.2f} "
              f"{'∞' if e is None else e:>10} "
              f"{'∞' if t is None else f'{t:.3f}':>12}  {r.losses[-1]:.4f}")

    print("\nThe paper's trade-off is visible: async replicas cut per-epoch "
          "cost per worker\nbut need more epochs; rep-k replication buys "
          "statistical efficiency back.")
    return runs


if __name__ == "__main__":
    main()
