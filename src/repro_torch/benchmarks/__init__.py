"""The paper's tables and figures through the port: twins of the
repository's ``benchmarks/`` drivers for Table 1, Figures 1-3, the
mitigation, the objective ablation and the beyond-paper experiments.
``python -m repro_torch.benchmarks.run [names] [--device cpu]``."""
