"""Analysis of the port's steps.

* :mod:`repro_torch.analysis.roofline` — the three-term roofline
  (compute, HBM, link) per (arch x input shape x mesh) on the H100, over
  the records of the dry run (:mod:`repro_torch.launch.dryrun`).  It
  imports the config machinery and is not re-exported here.

The reference's linter (``repro.analysis`` ``base``, ``cli``,
``lintconfig``, ``walker``, ``rules``) has no twin yet (``ROADMAP.md``
queue 1, item 10).
"""
