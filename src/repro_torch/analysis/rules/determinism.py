"""RPL002 determinism: no unseeded module-level RNG in the serving core.

Greedy-decode token parity, seeded chaos replay, and the offline-log /
OPE pipeline are all bit-for-bit reproducibility contracts (tested as
such).  Module-level RNG (``random.random()``, ``np.random.rand()``,
``torch.randn(...)``) draws from hidden global state that any import
can perturb — one call in a serving path silently breaks every parity
test downstream.  The repo idiom is an explicitly seeded generator
object threaded through constructors: ``np.random.default_rng(seed)``,
and in torch a ``torch.Generator(device).manual_seed(seed)`` passed as
``generator=`` (``models/schema.py`` draws its weights so).

Flagged: any call into the stdlib ``random`` module, any
``numpy.random.*`` legacy global function (``rand``/``randn``/
``seed``/``shuffle``/...), ``numpy.random.default_rng()`` /
``numpy.random.Generator`` constructions *with no seed argument*; and
torch's global generator: a ``torch.*`` draw (``rand``, ``randn``,
``randint``, ``randperm``, ``normal``, ...) or an in-place
``.uniform_()`` / ``.normal_()`` / ... without ``generator=``, the
``*_like`` draws (which take no generator), and global seeding
(``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed*``).
Instance methods on a seeded generator (``rng.normal(...)``) are fine
— the receiver is a local name, not the module.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.base import Finding, Rule
from repro_torch.analysis.walker import dotted_name, qualified

# numpy legacy global-state functions (module-level draws + seeding)
_NP_GLOBAL = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "normal", "uniform",
    "standard_normal", "beta", "binomial", "poisson", "exponential",
    "gamma", "seed", "get_state", "set_state", "bytes",
}
# torch draws that take a `generator=` (global generator without one)
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson",
}
# torch draws that take no generator at all
_TORCH_LIKE = {"rand_like", "randn_like", "randint_like"}
# seeding torch's global generators
_TORCH_SEEDING = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
}
# in-place tensor draws (a method on any tensor)
_TORCH_INPLACE = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "geometric_", "log_normal_", "cauchy_",
}


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg in ("generator", None) for kw in node.keywords)


class DeterminismRule(Rule):
    id = "RPL002"
    name = "determinism"
    summary = ("unseeded module-level RNG (random.* / np.random.* / "
               "torch's global generator) in a deterministic path")

    def check(self, ctx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = qualified(dotted_name(node.func), ctx.imports)
            if name.startswith("random."):
                yield self.finding(
                    ctx, node,
                    f"stdlib global RNG `{name}()` — use an explicitly "
                    f"seeded np.random.default_rng(seed) threaded "
                    f"through the constructor")
            elif name.startswith("numpy.random."):
                tail = name.split(".", 2)[2]
                if tail in _NP_GLOBAL:
                    yield self.finding(
                        ctx, node,
                        f"numpy global RNG `np.random.{tail}()` draws "
                        f"from hidden shared state — use a seeded "
                        f"np.random.default_rng(seed) instance")
                elif tail in ("default_rng", "Generator", "PCG64",
                              "SeedSequence") and not (node.args
                                                       or node.keywords):
                    yield self.finding(
                        ctx, node,
                        f"`np.random.{tail}()` without a seed is "
                        f"entropy-seeded — pass an explicit seed so "
                        f"runs replay bit-for-bit")
            elif name in _TORCH_SEEDING:
                yield self.finding(
                    ctx, node,
                    f"`{name}()` seeds torch's global generator, shared "
                    f"by every caller — pass a "
                    f"torch.Generator(device).manual_seed(seed) as "
                    f"generator= instead")
            elif name.startswith("torch.") and (
                    name[6:] in _TORCH_LIKE
                    or (name[6:] in _TORCH_DRAWS
                        and not _has_generator(node))):
                yield self.finding(
                    ctx, node,
                    f"`{name}()` draws from torch's global generator — "
                    f"pass generator=torch.Generator(device)"
                    f".manual_seed(seed)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TORCH_INPLACE \
                    and not _has_generator(node):
                yield self.finding(
                    ctx, node,
                    f"in-place `.{node.func.attr}()` without generator= "
                    f"draws from torch's global generator — pass "
                    f"generator=torch.Generator(device).manual_seed(seed)")
