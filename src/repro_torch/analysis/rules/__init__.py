"""reprolint rule modules — importing this package registers them all.

No RPL003 (the JAX package's jit-donation rule): the port has no
``jax.jit``, no ``donate_argnums`` and no ``out_shardings`` — its caches
update in place and ``models/transformer.py::check_tensor_parallel``
checks tensor-parallel placements at run time — so the id stays
unregistered and ``--rules RPL003`` is an unknown id.
"""
from repro_torch.analysis.rules import (clock, cuda_smem,  # noqa: F401
                                        determinism, exceptions,
                                        metrics_hygiene, threads)
