"""The port's twins of the reference's paper drivers (Tables 4, 6, 7 and
Figs. 8, 11, 14, 22, 24), one module each, run by
``python -m repro_torch.benchmarks.run``."""
