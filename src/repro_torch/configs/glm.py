"""The paper's own tasks as selectable configs: {dataset} x {LR, SVM}.

These drive the GLM benchmarks the way the LM arch configs drive serving:
``get_glm("news-lr")`` returns everything needed to instantiate the
training problem.  The same ten tasks and Table 6 mapping as the
reference's ``configs/glm.py``; datasets land on ``device`` (``cuda``
unless the caller says).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import sgd
from repro_torch.data import synthetic


@dataclasses.dataclass(frozen=True)
class GLMTaskConfig:
    name: str
    dataset: str                 # synthetic Table-3 stand-in name
    task: str                    # "lr" | "svm"
    default_strategy: str = "sync"
    # paper Table 6 optimal async configuration, translated to our engine
    async_access: str = "chunk"
    async_rep_k: int = 0
    async_replicas: int = 8

    def make_dataset(self, *, max_n: int | None = 8192, seed: int = 0,
                     device=None):
        return synthetic.paper_dataset(self.dataset, max_n=max_n, seed=seed,
                                       device=device)

    def async_strategy(self) -> "sgd.AsyncLocalSGD":
        return sgd.AsyncLocalSGD(replicas=self.async_replicas, local_batch=1,
                                 access=self.async_access,
                                 rep_k=self.async_rep_k)


# paper Table 6 (optimal Hogwild configs) mapped to engine knobs:
#   row-rr/row-ch -> access; rep-10 -> rep_k=10; kernel/block -> replicas
_TABLE6 = {
    ("covtype", "lr"): ("chunk", 0),     # col-rr + block + no-rep
    ("w8a", "lr"): ("round_robin", 10),  # row-rr + kernel + rep-10
    ("real-sim", "lr"): ("chunk", 10),   # row-ch + kernel + rep-10
    ("rcv1", "lr"): ("chunk", 0),        # row-ch + kernel + no-rep
    ("news", "lr"): ("round_robin", 10),
    ("covtype", "svm"): ("chunk", 0),
    ("w8a", "svm"): ("chunk", 10),
    ("real-sim", "svm"): ("round_robin", 10),
    ("rcv1", "svm"): ("round_robin", 10),
    ("news", "svm"): ("round_robin", 10),
}

GLM_CONFIGS = {
    f"{ds}-{task}": GLMTaskConfig(
        name=f"{ds}-{task}", dataset=ds, task=task,
        async_access=_TABLE6[(ds, task)][0],
        async_rep_k=_TABLE6[(ds, task)][1])
    for (ds, task) in _TABLE6
}


def get_glm(name: str) -> GLMTaskConfig:
    return GLM_CONFIGS[name]
