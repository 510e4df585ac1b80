"""The port's continuous engine (host scheduler + dense-cache executor)
against the reference engine: identical greedy tokens for the same
prompts, with more prompts than slots (slot reuse), mixed prompt lengths
(admission grouping) and batched prefill; the one-allocation invariant;
and per-slot NaN quarantine that leaves the peers untouched."""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.continuous import ContinuousEngine


@pytest.fixture(scope="module")
def models():
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    rm, tm = ref_build(rc), build_model(tc)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       rm.init(jax.random.PRNGKey(0)))
    return (rm, jax.tree_util.tree_map(jnp.asarray, np_params),
            tm, params_from_numpy(np_params, device="cpu"))


def _prompts(n, lengths, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(4, vocab, size=lengths[i % len(lengths)]))
            for i in range(n)]


KW = dict(num_slots=3, max_len=40, max_new_cap=12, sync_every=4)


class _HostData(TorchDispatchMode):
    """Records the ops that make a tensor of host data."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("prefill_batch", [1, 2])
def test_generate_many_tokens_identical_to_reference(models, prefill_batch):
    rm, rp, tm, tp = models
    # 7 prompts on 3 slots: slots are reused; two prompt lengths: the
    # admission grouping batches equal lengths only
    prompts = _prompts(7, [6, 11, 6, 9])
    ref = RefEngine(rm, rp, prefill_batch=prefill_batch, **KW)
    port = ContinuousEngine(tm, tp, prefill_batch=prefill_batch, **KW)
    want = ref.generate_many(prompts, max_new_tokens=10)
    got = port.generate_many(prompts, max_new_tokens=10)
    assert [list(g.tokens) for g in got] == [list(w.tokens) for w in want]
    assert [g.n_steps for g in got] == [w.n_steps for w in want]
    for f in ("n_admitted", "n_completed", "n_prefills", "n_decode_chunks",
              "n_decode_steps", "max_concurrent"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    assert port.stats.max_concurrent == 3
    assert port.stats.cache_allocations == 2


def test_one_cache_allocation_per_lifetime(models):
    _, _, tm, tp = models
    calls = []

    class Counting:
        def __getattr__(self, name):
            return getattr(tm, name)

        def init_cache(self, batch, max_len, **kw):
            calls.append((batch, max_len))
            return tm.init_cache(batch, max_len, **kw)

    eng = ContinuousEngine(Counting(), tp, prefill_batch=2, **KW)
    assert calls == [(3, 40), (2, 40)]       # slot cache + prefill scratch
    for wave in range(2):
        eng.generate_many(_prompts(4, [7], seed=wave), max_new_tokens=6)
    assert len(calls) == 2 and eng.stats.cache_allocations == 2
    assert eng.stats.n_completed == 8


def test_nan_quarantine_leaves_peers_token_identical(models):
    """Poison slot 1's KV rows with NaN right after admission: its decode
    logits turn NaN on the device, the executor deactivates and flags
    the slot, the scheduler quarantines it and fails only its request;
    the other slots decode exactly as in a clean run."""
    _, _, tm, tp = models
    prompts = _prompts(3, [8], seed=5)
    clean = ContinuousEngine(tm, tp, prefill_batch=3, **KW)
    want = clean.generate_many(prompts, max_new_tokens=8)

    eng = ContinuousEngine(tm, tp, prefill_batch=3, **KW)
    ex = eng.executor
    admit = ex.admit

    def poisoned_admit(*a):
        admit(*a)
        ex._cache["blocks"]["p0"]["k"][:, 1] = float("nan")
    ex.admit = poisoned_admit
    got = eng.generate_many(prompts, max_new_tokens=8)

    assert got[1].failed == "nan/inf decode logits" and got[1].transient
    assert list(got[0].tokens) == list(want[0].tokens)
    assert list(got[2].tokens) == list(want[2].tokens)
    assert eng.stats.n_quarantined == 1 and eng.stats.n_nan_trips == 1
    assert eng.quarantined_slots == {1}
    assert eng.reset_quarantine() == [1]
    assert not ex.slot_faults().any()


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "dbrx-132b", "gemma3-12b",
                                  "gemma3-12b-ring", "minicpm3-4b",
                                  "minicpm3-4b-absorb", "deepseek-v3-671b",
                                  "phi-3-vision-4.2b", "whisper-large-v3"])
def test_decode_chunk_issues_no_host_sync(arch, request, monkeypatch):
    """A decode chunk's `sync_every` steps never read a device value back
    to the host: every slot-state update stays a tensor op, and so does
    an MoE layer's routing (dbrx SMOKE: its group sizes stay on the
    device), a sliding-window layer's mask (gemma3 SMOKE), the ring
    cache's writes and lengths (its window cut to 8: the chunk's
    positions 8-11 wrap the ring) and an MLA layer's compressed-cache
    writes and masks, naive and absorbed (minicpm3 and deepseek SMOKE;
    MTP is a training head and does not decode), phi-3-vision's decoder
    and whisper's cross-attention over its cache (their SMOKE).  Nor
    does a step make a
    tensor of host data (``torch.tensor`` of a number: on the card a
    copy that waits for the stream)."""
    engine_kw = {}
    if arch == "qwen1.5-32b":
        _, _, tm, tp = request.getfixturevalue("models")
    else:
        base = arch.removesuffix("-ring").removesuffix("-absorb")
        cfg = dataclasses.replace(get_config(base, "smoke"), dtype="float32")
        if arch.endswith("-ring"):
            cfg = dataclasses.replace(cfg, sliding_window=8,
                                      window_ring_cache=True)
        engine_kw["mla_absorb"] = arch.endswith("-absorb")
        tm = build_model(cfg)
        tp = tm.init(seed=0, device="cpu")
    eng = ContinuousEngine(tm, tp, prefill_batch=3, **KW, **engine_kw)
    for rid, p in enumerate(_prompts(3, [8], seed=2)):
        eng.submit(rid, p, 8)
    eng.step()                                   # admit + first sync
    if arch.endswith("-ring"):
        assert int(eng.executor._cache["pos"].min()) >= 8  # past W
    reads = []
    for name in ("item", "tolist", "numpy", "cpu", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    with _HostData() as made:
        eng.executor.decode_chunk()
    monkeypatch.undo()
    assert reads == []
    assert made.ops == []
