"""Analysis of the port.

* ``reprolint`` (:mod:`repro_torch.analysis.base`,
  :mod:`repro_torch.analysis.walker`, :mod:`repro_torch.analysis.rules`)
  — the invariant linter, run as ``python -m repro_torch.analysis
  src/repro_torch chip_smoke.py``: the JAX package's framework-neutral
  rules (RPL001 clock, RPL002 determinism with torch's global
  generator added, RPL005 threads, RPL006 exceptions, RPL007 metrics)
  over the ``.py`` files, and RPL004 ``cuda-smem-budget`` over the CUDA
  kernel sources (``.cu`` / ``.cuh``): a block's shared memory in
  place of Pallas's VMEM.  There is no RPL003: the port has no jit
  donation.  The port's test gate enforces zero unsuppressed findings.
  Stdlib only: it imports neither torch nor jax, nor the JAX package.
* :mod:`repro_torch.analysis.roofline` — the three-term roofline
  (compute, HBM, link) per (arch x input shape x mesh) on the H100, over
  the records of the dry run (:mod:`repro_torch.launch.dryrun`).  It
  imports the config machinery and is not re-exported here.
"""
from repro_torch.analysis.base import Finding, LintResult, Rule, all_rules
from repro_torch.analysis.lintconfig import (DEFAULT_CONFIG, LintConfig,
                                             RuleConfig)
from repro_torch.analysis.walker import CudaContext, ModuleContext, run_lint

__all__ = [
    "Finding", "LintResult", "Rule", "all_rules",
    "LintConfig", "RuleConfig", "DEFAULT_CONFIG",
    "ModuleContext", "CudaContext", "run_lint",
]
