"""The port's ``ShardedExecutor`` on spawned gloo worlds (one process a
rank, ``tests/torch_dist.py``) against the reference's single-device
executor.

The reference's own sharded path is red on this jax (queue 3 of
``ROADMAP.md``), so every layout is held against the reference's
``SingleDeviceExecutor`` tokens, on the reference tests' engines and
prompts (``tests/test_sharded_executor.py``, ``tests/test_paged_engine.py``):
qwen SMOKE in float32 at dp=2, mp=2, dp=2 x mp=2, dp=4 and pod=2, dense
and paged.  Also: the layout each rank takes (its slots, its kv heads,
its shards of the weights, one cache allocation, the local shapes the
dry run's specs give), the rows of an admission group each rank
prefills (its share over the batch axes, as the reference's
``_batch_entry`` splits them) and shared pages borrowed from another
rank, prefix hits as the reference's partitioned pool makes them, the
routes of the row exchange and the borrow at every rank of pod=2 x
dp=2, the mp=2 logits, every family
at dp=2 and dbrx / gemma3 at dp=2 x mp=2 against the port's own
single-device engine (itself held against the reference in
``test_torch_engine.py`` and ``test_torch_families.py``), the refusal of
Mamba2 and Whisper at mp=2 (minicpm3's MLA serving there with the
single-device tokens instead), the reference's chaos plans, and the
in-process world of one (whose admissions issue no collective of their
own).

The ``head_dim`` route (kv heads, or heads too, that mp does not
divide): at dp=1 x mp=4, a qwen SMOKE variant with 6 heads and 6 kv
heads (both on head_dim; rope's partner columns two ranks away),
command-r SMOKE as published (8 / 2 / 32: q heads split, kv on
head_dim) and gemma3 SMOKE (4 / 2 / 64, its windowed layers, and with
the ring cache), and at dp=2 x mp=2 command-r SMOKE with one kv head:
greedy tokens identical to the port's single-device engine, dense,
paged (prefix sharing) and paged int8; the prefill's and 3 decode
steps' logits within ``LOGIT_RTOL`` over the dense cache and
``INT8_LOGIT_RTOL`` over its int8 form; each rank's head_dim columns.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
from collections import Counter
from unittest import mock

import jax
import numpy as np
import pytest
import torch.distributed as dist

import torch_dist as W
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.serving.continuous import ContinuousEngine as RefEngine
from repro.serving.executor import SingleDeviceExecutor as RefExecutor
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.schema import tree_leaves

# (spec, pod, dp, mp)
LAYOUTS = {"dp2": ("dp=2", 1, 2, 1), "mp2": ("dp=1,mp=2", 1, 1, 2),
           "dp2mp2": ("dp=2,mp=2", 1, 2, 2), "dp4": ("dp=4", 1, 4, 1),
           "pod2": ("pod=2,dp=1", 2, 1, 1)}
LOGIT_RTOL = 1e-4   # of max |logit|: float32, the tensor-parallel partial
#                     sums added in another order
# the families of the mp = 2 refusal test; MLA (minicpm3) is served
# there since its route exists (tests/test_torch_mla_tp.py)
MP_REFUSED = ("minicpm3-4b", "mamba2-130m", "whisper-large-v3")
# the int8 cache: a k / v element an ulp of the tensor-parallel sums
# moves across a rounding boundary takes the next code, a whole scale
# step (up to 7.7e-5 of max |logit| seen here)
INT8_LOGIT_RTOL = 1e-3
HEAD_DIM = {"qwen6": ("qwen1.5-32b", {"n_heads": 6, "n_kv_heads": 6}),
            "command-r": ("command-r-35b", {}),
            "gemma3": ("gemma3-12b", {}),
            "gemma3_ring": ("gemma3-12b", {"window_ring_cache": True})}
HEAD_DIM_MIXED = {"command-r_kv1": ("command-r-35b", {"n_kv_heads": 1})}
HEAD_DIM_LAYOUTS = {"mp4": ("dp=1,mp=4", HEAD_DIM),
                    "dp2mp2": ("dp=2,mp=2", HEAD_DIM_MIXED)}
HEAD_DIM_ENGINES = ("dense", "paged", "paged_int8")


def _rows_per_rank(pb, pod, dp):
    """The rows of a ``pb``-row admission group one rank prefills: the
    reference's ``_batch_entry`` splits them over pod x data, else over
    data, else not at all."""
    if pb % (pod * dp) == 0:
        return pb // (pod * dp)
    return pb // dp if pb % dp == 0 else pb


def _prompts(vocab):
    """The reference tests' prompts: tests/test_sharded_executor.py's
    dp=4,mp=2 set, and tests/test_paged_engine.py's prefix-sharing set."""
    rng = np.random.default_rng(0)
    dense = [list(map(int, rng.integers(4, vocab, size=n)))
             for n in (10, 7, 10, 5, 7, 9, 12, 6)]
    rng = np.random.default_rng(0)
    base = list(rng.integers(4, vocab, size=16))
    paged = [list(map(int, rng.integers(4, vocab, size=n)))
             for n in (10, 7, 10, 5)]
    paged += [list(map(int, base + list(rng.integers(4, vocab, size=4))))
              for _ in range(4)]
    return dense, paged


def _ref_paged(rm, rp, prompts, partitions, quant):
    """The reference's single-device paged engine, its host pool cut into
    ``partitions`` as a dp-wide mesh cuts it: two waves' tokens and the
    prompt tokens served from shared pages."""
    model = rm if not quant else ref_build(dataclasses.replace(
        rm.cfg, kv_quant_int8=True))
    ex = RefExecutor(model, rp, **W.PAGED_KW)
    ex.page_partitions = partitions
    eng = RefEngine(executor=ex)
    waves = [[list(map(int, g.tokens)) for g in
              eng.generate_many(prompts, max_new_tokens=12)]
             for _ in range(2)]
    return waves, eng.stats.prefill_tokens_avoided


@pytest.fixture(scope="module")
def ref():
    cfg = dataclasses.replace(ref_config(W.QWEN, "smoke"), dtype="float32")
    rm = ref_build(cfg)
    rp = rm.init(jax.random.PRNGKey(0))
    dense, paged = _prompts(cfg.vocab_size)
    out = {"np": jax.tree_util.tree_map(np.asarray, rp), "cfg": cfg,
           "prompts": (dense, paged)}
    out["dense"] = [list(map(int, g.tokens)) for g in RefEngine(
        rm, rp, **W.DENSE_KW).generate_many(dense, max_new_tokens=12)]
    for dp in (1, 2, 4):
        out[("paged", dp)] = _ref_paged(rm, rp, paged, dp, False)
    out[("paged_int8", 2)] = _ref_paged(rm, rp, paged, 2, True)
    toks = np.asarray([p[:5] for p in dense[:3]], np.int32)
    pre, cache = rm.prefill(rp, {"tokens": toks}, rm.init_cache(3, 64))
    nxt = np.asarray(pre[:, -1]).argmax(-1)
    dec, _ = rm.decode(rp, {"tokens": nxt[:, None].astype(np.int32)}, cache)
    out["logits"] = (toks, np.asarray(pre), np.asarray(dec))
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """One spawned world a layout, each rank's results.  dp=2 also serves
    every family, mp=2 also tries the families it must refuse, dp=2 x
    mp=2 also serves dbrx and gemma3 and the int8 pool and runs the
    chaos plans."""
    tmp = tmp_path_factory.mktemp("sharded")
    dense, paged = ref["prompts"]
    out = {}
    for name, (spec, pod, dp, mp) in LAYOUTS.items():
        logits = ref["logits"][0] if mp > 1 else None
        out[name] = W.run_world(W.serve_layout, pod * dp * mp, tmp, spec,
                                ref["np"], dense, paged, logits,
                                name == "dp2mp2")
    fam_prompts = dense[:6]
    out["families"] = W.run_world(W.serve_families, 2, tmp, "dp=2",
                                  list(ARCH_IDS), fam_prompts)
    out["families_mp"] = W.run_world(
        W.serve_families, 4, tmp, "dp=2,mp=2",
        ("dbrx-132b", "gemma3-12b") + MP_REFUSED, fam_prompts)
    out["chaos"] = W.run_world(W.chaos_run, 4, tmp, "dp=2,mp=2", ref["np"],
                               dense[:6], 6)
    return out


@pytest.fixture(scope="module")
def head_dim_worlds(tmp_path_factory):
    """One world a layout of the head_dim cases, on prompts of 20-40
    tokens (past gemma3 SMOKE's window of 32 with 12 new ones) and four
    sharing a 16-token prefix."""
    tmp = tmp_path_factory.mktemp("head_dim")
    rng = np.random.default_rng(0)
    base = list(rng.integers(4, 512, size=16))
    prompts = [list(map(int, rng.integers(4, 512, size=n)))
               for n in (20, 33, 40, 27)]
    prompts += [list(map(int, base + list(rng.integers(4, 512, size=n))))
                for n in (6, 12, 20, 9)]
    return {name: W.run_world(W.serve_head_dim, 4, tmp, spec,
                              [(k, a, o) for k, (a, o) in cases.items()],
                              prompts, 12)
            for name, (spec, cases) in HEAD_DIM_LAYOUTS.items()}


HEAD_DIM_TOKEN_CASES = [
    (layout, key, eng) for layout, (_, cases) in HEAD_DIM_LAYOUTS.items()
    for key, (_, over) in cases.items()
    for eng in (HEAD_DIM_ENGINES if "window_ring_cache" not in over
                else ("dense",))]


@pytest.mark.parametrize("layout,key,engine", HEAD_DIM_TOKEN_CASES,
                         ids=["-".join(c) for c in HEAD_DIM_TOKEN_CASES])
def test_head_dim_split_serves_the_single_device_tokens(head_dim_worlds,
                                                        layout, key,
                                                        engine):
    for rank in head_dim_worlds[layout]:
        single, got = rank[key][engine]
        assert len(single) == 8 and all(len(t) == 12 for t in single)
        assert got == single


HEAD_DIM_LOGIT_CASES = [(layout, key, quant)
                        for layout, (_, cases) in HEAD_DIM_LAYOUTS.items()
                        for key in cases for quant in (False, True)]


@pytest.mark.parametrize("layout,key,quant", HEAD_DIM_LOGIT_CASES,
                         ids=[f"{lay}-{k}-{'int8' if q else 'plain'}"
                              for lay, k, q in HEAD_DIM_LOGIT_CASES])
def test_head_dim_split_logits_match_one_device(head_dim_worlds, layout,
                                                key, quant):
    bar = INT8_LOGIT_RTOL if quant else LOGIT_RTOL
    for rank in head_dim_worlds[layout]:
        want = rank[key][("logits", quant, "single")]
        got = rank[key][("logits", quant, "sharded")]
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= bar, err


@pytest.mark.parametrize("layout", HEAD_DIM_LAYOUTS)
def test_head_dim_split_leaves_on_each_rank(head_dim_worlds, layout):
    """wk, the slot cache's and the prefill scratch's k / v (or k_q /
    v_q) hold head_dim / mp columns of every kv head, the int8 scales
    every kv head whole; wq its heads where mp divides them, else its
    columns."""
    spec, cases = HEAD_DIM_LAYOUTS[layout]
    mp = 4 if layout == "mp4" else 2
    for rank in head_dim_worlds[layout]:
        for key, (arch, over) in cases.items():
            cfg = dataclasses.replace(get_config(arch, "smoke"), **over)
            H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            for eng in HEAD_DIM_ENGINES:
                if eng not in rank[key]:
                    continue
                sh = rank[key][eng + "_shapes"]
                assert sh["wk"][-2:] == (Hkv, Dh // mp)
                assert sh["wq"][-2:] == ((H // mp, Dh) if H % mp == 0
                                         else (H, Dh // mp))
                # the slot cache and the prefill scratch (resolved on
                # model alone) alike
                for c, shape in [*sh["cache"].items(),
                                 *sh["scratch"].items()]:
                    assert shape[-2:] == ((Hkv, 1) if c.endswith("_s")
                                          else (Hkv, Dh // mp)), (c, shape)
                assert sh["scratch"].keys() == sh["cache"].keys()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dense_tokens_match_the_reference_single_device(ref, worlds,
                                                        layout):
    for rank in worlds[layout]:
        assert rank["dense"] == ref["dense"]
        assert rank["dense_allocs"] == 2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_tokens_and_prefix_hits_match_the_reference(ref, worlds,
                                                          layout):
    """Both waves' tokens and the prompt tokens served from shared pages
    equal the reference's single-device paged engine with its pool cut
    as pod x dp cuts it (a slot's pages stay in its rank's partition)."""
    _, pod, dp, _ = LAYOUTS[layout]
    waves, avoided = ref[("paged", pod * dp)]
    assert avoided > 0
    for rank in worlds[layout]:
        assert rank["paged"] == waves
        st = rank["paged_stats"]
        assert st["avoided"] == avoided
        assert st["partitions"] == pod * dp and st["allocs"] == 2


def test_paged_int8_tokens_match_the_reference(ref, worlds):
    waves, avoided = ref[("paged_int8", 2)]
    for rank in worlds["dp2mp2"]:
        assert rank["paged_int8"] == waves
        assert rank["paged_int8_stats"]["avoided"] == avoided


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_rank_holds_its_slots_heads_and_shards(ref, worlds, layout):
    """Slots [b S / n, (b + 1) S / n) at batch index b (pod-major) of the
    n = pod x dp batch shards; the slot cache and the page pool hold the
    rank's slots or pages and kv heads, the prefill scratch the rank's
    share of the rows and its kv heads; the weights the rank's heads,
    d_ff columns and vocab rows (at mp = 1 the caller's own tensors)."""
    _, pod, dp, mp = LAYOUTS[layout]
    n = pod * dp
    cfg = ref["cfg"]
    S, L, Hkv, Dh = 4, 64, cfg.n_kv_heads, cfg.head_dim
    nb = cfg.n_layers
    NP = S * (64 // 8 + 1)
    for rank in worlds[layout]:
        b = rank["batch_index"]
        assert b == rank["coords"].get("pod", 0) * dp + rank["coords"][
            "data"]
        assert rank["slot_base"] == b * S // n
        assert rank["slots_here"] == S // n
        assert rank["cache_k"] == (nb, S // n, L, Hkv // mp, Dh)
        assert rank["scratch_k"] == (nb, _rows_per_rank(4, pod, dp), L,
                                     Hkv // mp, Dh)
        assert rank["paged_stats"]["pool"] == (nb, NP // n, 8, Hkv // mp,
                                               Dh)
        assert rank["paged_stats"]["table"] == (S // n, 64 // 8 + 1)
        assert rank["paged_stats"]["page_base"] == b * NP // n
        assert rank["params"] == {
            "wq": (nb, cfg.d_model, cfg.n_heads // mp, Dh),
            "w_gate": (nb, cfg.d_model, cfg.d_ff // mp),
            "embed": (cfg.padded_vocab // mp, cfg.d_model)}
        assert rank["shared_embed"] == (mp == 1)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_rank_prefills_its_share_of_the_rows(worlds, layout):
    """Every admission's prefill runs on the rank's share of the rows:
    PB / (pod x dp) where that divides, else PB / dp, else all PB (the
    dense engine's PB = 4, the paged engines' PB = 2)."""
    _, pod, dp, _ = LAYOUTS[layout]
    for rank in worlds[layout]:
        for eng, pb in (("dense", 4), ("paged", 2), ("paged_int8", 2)):
            if eng in rank:
                rows = rank[eng + "_rows"]
                assert rows and set(rows) == {_rows_per_rank(pb, pod, dp)}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_caches_have_the_dry_run_local_shapes(worlds, layout):
    """Each rank's prefill scratch (and dense slot cache) leaf for leaf
    has the local shapes ``launch/specs.py::cache_specs_at`` gives."""
    for rank in worlds[layout]:
        for eng in ("dense", "paged", "paged_int8"):
            if eng not in rank:
                continue
            shapes = rank[eng + "_shapes"]
            assert set(shapes) == ({"scratch", "cache"} if eng == "dense"
                                   else {"scratch"})
            for got, want in shapes.values():
                assert got == want


def test_paged_rows_borrow_pages_across_ranks(ref, worlds):
    """At dp=2 some admission's rows hold shared pages that the other
    rank's partition holds, and their tokens are the reference's."""
    waves, _ = ref[("paged", 2)]
    assert sum(sum(rank["paged_borrows"]) for rank in worlds["dp2"]) > 0
    for rank in worlds["dp2"]:
        assert rank["paged"] == waves


def test_exchange_routes_reach_every_row_and_block_once():
    """The row exchange's and the borrow's routes at every rank of a
    pod=2 x dp=2 batch group, the rows split over pod x data (PB = 4)
    and over data with each pod repeating (PB = 2): every row with a slot
    reaches the rank holding the slot, from a rank whose share holds it,
    exactly once (or is prefilled there); every shared page reaches each
    rank prefilling its row, from its holder, and a sentinel none."""
    from repro_torch.serving.executor import _page_routes, _row_routes
    S, n, NP, mb = 8, 4, 64, 4
    rng = np.random.default_rng(0)
    for pb, row_shards in ((4, 4), (2, 2)):
        per = pb // row_shards
        share = {q: range(q % row_shards * per, (q % row_shards + 1) * per)
                 for q in range(n)}
        slot_idx = np.full(pb, S, np.int32)
        slot_idx[:pb - 1] = rng.permutation(S)[:pb - 1]   # one unused row
        rows, src, dst = _row_routes(slot_idx, S, n, row_shards, pb)
        for r in range(pb):
            if slot_idx[r] == S:
                assert r not in rows
                continue
            owner = slot_idx[r] // (S // n)
            came = [s for rr, s, d in zip(rows, src, dst) if rr == r]
            assert all(d == owner for rr, d in zip(rows, dst) if rr == r)
            if r in share[owner]:
                assert came == []
            else:
                assert len(came) == 1 and r in share[came[0]]
                assert came[0] // row_shards == owner // row_shards
        gsrc = rng.integers(0, NP, (pb, mb)).astype(np.int32)
        gsrc[0, -1] = NP                                     # the sentinel
        pages, holder, cross = _page_routes(gsrc, n, row_shards, NP)
        for q in range(n):
            want = gsrc[list(share[q])].reshape(-1)
            assert (pages[q] == want).all()
            assert (holder[q] == np.where(want < NP, want // (NP // n),
                                          n)).all()
            assert (cross[q] == ((want < NP)
                                 & (want // (NP // n) != q))).all()


@pytest.mark.parametrize("layout", ["mp2", "dp2mp2"])
def test_tensor_parallel_logits_match_the_reference(ref, worlds, layout):
    _, pre, dec = ref["logits"]
    for rank in worlds[layout]:
        for got, want in zip(rank["logits"], (pre, dec)):
            assert got.shape == want.shape
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= LOGIT_RTOL, err


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_serves_at_dp2(worlds, arch):
    """Each rank prefills one row of FAMILY_KW's two: every cache leaf
    (MLA's latent pair, Mamba2's state, Whisper's cross cache) crosses
    ranks in the row exchange."""
    for rank in worlds["families"]:
        kind, *res = rank[arch]
        assert kind == "served", res
        want, got = res
        assert got == want
        assert rank[arch + "_rows"] and set(rank[arch + "_rows"]) == {1}


@pytest.mark.parametrize("arch", ["dbrx-132b", "gemma3-12b"])
def test_moe_and_windowed_families_serve_at_dp2_mp2(worlds, arch):
    for rank in worlds["families_mp"]:
        kind, *res = rank[arch]
        assert kind == "served", res
        want, got = res
        assert got == want


@pytest.mark.parametrize("arch", MP_REFUSED)
def test_mla_mamba2_and_whisper_are_refused_at_mp2(worlds, arch):
    """No collective exists for Mamba2's d_inner or Whisper's cross and
    encoder layers: the executor refuses before any collective, naming
    the leaf, its spec and the roadmap item.  MLA's latent has its route
    now: minicpm3 serves at dp=2 x mp=2 with the single-device tokens."""
    for rank in worlds["families_mp"]:
        if get_config(arch, "smoke").attn_type == "mla":
            kind, *res = rank[arch]
            assert kind == "served", res
            want, got = res
            assert got == want
            continue
        kind, msg = rank[arch]
        assert kind == "refused"
        assert "ROADMAP.md queue 1, item 9" in msg and "mp=2" in msg
        assert "resolved to (" in msg


def test_reference_chaos_plans_on_dp2_mp2(worlds):
    """The reference's NaN-on-slot-2 and requeued decode-fault plans,
    and the NaN plan through ``Gateway.serve``: every rank's outcomes,
    engine counters and ``GatewayStats`` equal the one-device run's."""
    for rank in worlds["chaos"]:
        single, sharded = rank["single"], rank["sharded"]
        assert sharded == single
        outs, trips, quarantined, reset, more = sharded["nan"]
        failed = [i for i, o in enumerate(outs) if o[0]]
        assert len(failed) == 1 and outs[failed[0]][1]
        assert trips == 1 and quarantined == [2] and reset == [2]
        for i, o in enumerate(outs):
            if i not in failed:
                assert o[2] == sharded["clean"][i]
        toks, faults, requeued = sharded["fault"]
        assert toks == sharded["clean"] and faults == 1 and requeued > 0
        assert sharded["gateway"]["served"] == 6
        assert sharded["gateway_engine"][0] == 1


def _collectives_outside_prefill(ex, model, run):
    """``run()``'s ``torch.distributed`` collectives, by name, that
    ``ex.admit`` / ``ex.admit_paged`` issue outside ``model.prefill``,
    and the count of admissions."""
    names = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "all_to_all_single", "all_to_all", "broadcast",
             "reduce_scatter_tensor", "send", "recv")
    depth, calls, issued = Counter(), Counter(), Counter()
    real = {n: getattr(dist, n) for n in names}

    def counting(n):
        def call(*a, **kw):
            if depth["admit"] and not depth["prefill"]:
                issued[n] += 1
            return real[n](*a, **kw)
        return call

    def inside(key, fn):
        def call(*a, **kw):
            depth[key] += 1
            calls[key] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[key] -= 1
        return call
    with mock.patch.multiple(dist, **{n: counting(n) for n in names}), \
            mock.patch.object(model, "prefill",
                              inside("prefill", model.prefill)), \
            mock.patch.object(ex, "admit", inside("admit", ex.admit)), \
            mock.patch.object(ex, "admit_paged",
                              inside("admit", ex.admit_paged)):
        run()
    return issued, calls["admit"]


def test_world_of_one_in_process(ref):
    """``make_serving_mesh("dp=1")`` with no process group makes a gloo
    world of one here; the sharded engine gives the reference's tokens
    and views of the caller's weights, prefills all PB rows, and its
    admissions, dense and paged, issue no collective beyond the model
    apply's own."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.continuous import ContinuousEngine
    assert not dist.is_initialized()
    cfg, model, params = W._model(W.QWEN, ref["np"])
    try:
        mesh = make_serving_mesh("dp=1", cfg, device="cpu")
        assert dist.get_world_size() == 1 and mesh.coords == {
            "data": 0, "model": 0}
        eng = ContinuousEngine(model, params, mesh=mesh, **W.DENSE_KW)
        got = []
        issued, admits = _collectives_outside_prefill(
            eng.executor, model, lambda: got.extend(eng.generate_many(
                ref["prompts"][0], max_new_tokens=12)))
        assert [list(map(int, g.tokens)) for g in got] == ref["dense"]
        assert admits > 0 and not issued
        assert eng.executor.prefill_rows == slice(0, 4)
        assert eng.executor._pcache["pos"].shape == (4,)
        assert all(a is b for a, b in zip(tree_leaves(eng.executor.params),
                                          tree_leaves(params)))
        eng = ContinuousEngine(model, params, mesh=mesh, **W.PAGED_KW)
        waves, avoided = ref[("paged", 1)]
        got = []
        issued, admits = _collectives_outside_prefill(
            eng.executor, model, lambda: got.extend(eng.generate_many(
                ref["prompts"][1], max_new_tokens=12)))
        assert [list(map(int, g.tokens)) for g in got] == waves[0]
        assert admits > 0 and not issued
    finally:
        dist.destroy_process_group()


def test_indivisible_layouts_are_refused(ref):
    """num_slots and num_pages must split over pod x dp (the reference's
    messages); a mesh needs as many processes as the world has."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.executor import ShardedExecutor
    cfg, model, params = W._model(W.QWEN, ref["np"])
    with pytest.raises(ValueError, match="needs 2 processes but the world "
                                         "has 1"):
        make_serving_mesh("dp=2", cfg, device="cpu")
    try:
        mesh = make_serving_mesh("dp=1", cfg, device="cpu")
        mesh.devices = np.zeros((2, 1), int)   # a dp=2 grid on paper
        mesh.coords = {"data": 1, "model": 0}
        with pytest.raises(ValueError, match="num_slots=3 must be divisible"
                                             " by the mesh data-axis size 2"):
            ShardedExecutor(model, params, mesh=mesh, num_slots=3,
                            max_len=64)
        with pytest.raises(ValueError, match="num_pages=31 must be "
                                             "divisible by the mesh"):
            ShardedExecutor(model, params, mesh=mesh, num_slots=4,
                            max_len=64, paged=True, page_size=8,
                            num_pages=31)
        with pytest.raises(ValueError, match="num_pages=32 over 2 "
                                             "partition"):
            ShardedExecutor(model, params, mesh=mesh, num_slots=4,
                            max_len=64, paged=True, page_size=4,
                            num_pages=32)
        # a pod=2 x dp=1 grid on paper: the slots split over pod too
        mesh.axis_names = ("pod", "data", "model")
        mesh.devices = np.zeros((2, 1, 1), int)
        mesh.coords = {"pod": 1, "data": 0, "model": 0}
        with pytest.raises(ValueError, match="num_slots=3 must be divisible"
                                             " by the mesh data-axis size 2"):
            ShardedExecutor(model, params, mesh=mesh, num_slots=3,
                            max_len=64)
        with pytest.raises(ValueError, match="num_pages=35 must be "
                                             "divisible by the mesh "
                                             "data-axis size 2"):
            ShardedExecutor(model, params, mesh=mesh, num_slots=4,
                            max_len=64, paged=True, page_size=8,
                            num_pages=35)
    finally:
        dist.destroy_process_group()
