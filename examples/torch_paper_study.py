"""The full paper study on the PyTorch port, as one script: exploratory
axes x performance axes.

Runs the {update strategy} x {replication} x {access path} x {rep-k} grid
on one dense + one sparse synthetic dataset and prints the paper-style
comparison matrix (hardware efficiency / statistical efficiency / time to
convergence), ending with the paper's four headline findings checked
against the measured rows.  The twin of ``examples/paper_study.py``; runs
on ``cuda`` (the port's kernels) unless ``--device`` says otherwise.

    PYTHONPATH=src python examples/torch_paper_study.py
    PYTHONPATH=src python examples/torch_paper_study.py --device cpu --max-n 256 --epochs 3
"""
import argparse

from repro_torch.core import convergence, glm, sgd
from repro_torch.data import synthetic
from repro_torch.kernels import common


def run_grid(ds, task, epochs=12):
    """The grid's runs on ``ds`` (on the device its tensors are on)."""
    if ds.dense:
        def prob(s):
            return glm.GLMProblem(task, ds.X, ds.y, s)
    else:
        def prob(s):
            return (task, ds.ell, ds.y, s)

    grid = {
        "sync(batch)": (sgd.SyncSGD(), 1e-3),
        "seq(B=1)": (sgd.AsyncLocalSGD(replicas=1, local_batch=1), 1e-2),
        "async r8 chunk": (sgd.AsyncLocalSGD(replicas=8), 1e-2),
        "async r8 rr": (sgd.AsyncLocalSGD(replicas=8, access="round_robin"),
                        1e-2),
        "async r64 (thread)": (sgd.AsyncLocalSGD(replicas=64), 1e-2),
        "async r8 rep-10": (sgd.AsyncLocalSGD(replicas=8, rep_k=10), 1e-2),
    }
    runs = {}
    for name, (strat, step) in grid.items():
        if ds.n < getattr(strat, "replicas", 0) * 2:
            continue
        runs[name] = sgd.run(prob(step), strat, epochs,
                             sparse_data=not ds.dense)
    return runs


def report(name, runs):
    optimal = convergence.optimal_loss(runs.values())
    target = optimal * 1.01
    print(f"\n== {name} (optimal {optimal:.3f}) ==")
    print(f"{'config':22s} {'ms/ep':>8s} {'eps->1%':>8s} {'t->1% ms':>9s}")
    for cfg, r in runs.items():
        e, t = r.epochs_to(target), r.time_to(target)
        print(f"{cfg:22s} {1e3*r.time_per_epoch:8.2f} "
              f"{'inf' if e is None else e:>8} "
              f"{'inf' if t is None else f'{1e3*t:.1f}':>9}")
    return runs, target


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-n", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = common.device(args.device)

    dense = synthetic.paper_dataset("covtype", max_n=args.max_n, device=dev)
    sparse_ds = synthetic.paper_dataset("w8a", max_n=args.max_n, device=dev)

    print(f"device: {dev}")
    d_runs, d_t = report("covtype (dense) / LR",
                         run_grid(dense, "lr", args.epochs))
    report("w8a (sparse) / SVM", run_grid(sparse_ds, "svm", args.epochs))

    print("\n== paper findings checked ==")
    r8 = d_runs["async r8 chunk"]
    r64 = d_runs["async r64 (thread)"]
    print(f"1. more replicas -> worse statistical efficiency: "
          f"final loss r8={r8.losses[-1]:.3f} <= r64={r64.losses[-1]:.3f}: "
          f"{r8.losses[-1] <= r64.losses[-1] * 1.001}")
    rep = d_runs["async r8 rep-10"]
    base = d_runs["async r8 chunk"]
    print(f"2. rep-k costs hardware efficiency: "
          f"{rep.time_per_epoch:.2e} >= {base.time_per_epoch:.2e}: "
          f"{rep.time_per_epoch >= base.time_per_epoch * 0.7}")
    print(f"3. rep-k helps statistical efficiency: "
          f"final {rep.losses[-1]:.3f} <= {base.losses[-1]:.3f}: "
          f"{rep.losses[-1] <= base.losses[-1] * 1.01}")
    sync_t = d_runs["sync(batch)"].time_to(d_t)
    async_t = base.time_to(d_t)
    print(f"4. sync vs async winner is dataset-dependent "
          f"(dense: sync={sync_t} async={async_t})")
    return d_runs


if __name__ == "__main__":
    main()
