"""Whisper under tensor parallelism, on gloo worlds and by hand.

The resolver splits Whisper's encoder layers as it splits a decoder
layer (``encoder/attn/...`` and ``encoder/mlp/...`` on heads or
``head_dim`` and ``d_ff``), a decoder layer's cross sublayer as its
self-attention (``cross/wq`` ... ``cross/wo``), and the cache's
``cross_k`` / ``cross_v`` on kv heads or ``head_dim``; ``enc_pos`` and
the norms stay whole.  The port's route: the encoder runs with ``tp``,
its output is whole on every rank and enters ``cross/wk`` / ``cross/wv``
through ``f``; the cross-attention takes the heads placement's plain
call, or the head_dim route (``models/layers.py::_gqa_head_dim`` with
``cross=True``: summed float32 partial scores at S == 1, q, k and v
gathered and a block of whole heads a rank at S > 1).  The reference's
own sharded path is red on this jax, so the port's tensor parallelism is
held against the single-device port, and one layer of each kind against
the reference's ``apply_layer``; the single-device port is held against
the reference in ``tests/test_torch_whisper.py``.

Float32 SMOKE configs, seeded weights, one spawned gloo world a layout
(``tests/torch_dist.py::whisper_tp``):

* ``mp2``: whisper SMOKE (4 heads, d_model 256, 2 + 2 layers, 64
  frames) at mp = 2: 2 whole heads a rank;
* ``dp2mp2``: the same at dp = 2 x mp = 2;
* ``mp4``: whisper SMOKE widened to 6 heads and 6 kv heads (d_model
  384) at mp = 4: 16 of 64 columns a rank, head blocks of 2, 2, 1 and 1
  at S > 1 (whisper-large-v3's route at mp = 16, at SMOKE size).

Checks on each: a prefill of two prompts with the frames (the encoder,
the cross cache written) and 3 greedy decode steps: greedy tokens equal
to one device's, logits within ``LOGIT_RTOL``, each rank's columns or
heads of ``cross_k`` / ``cross_v`` within ``CACHE_RTOL`` of the
single-device cache; ``ShardedExecutor``'s dense engine fed tokens
alone: tokens equal, its cross cache zero; one decoder layer (a prefill
with ``enc_out`` into a cache, 2 decode steps reading its cross leaves)
and one encoder layer within ``LAYER_RTOL`` of the reference's
``apply_layer``; the sharded train step's loss (``LOSS_RTOL``) and every
leaf's gradient (``GRAD_TOL`` of its largest |gradient|) against the
single-device ``forward_train_loss``, ``enc_pos``, every encoder leaf
and ``cross/wk`` / ``cross/wv`` included (a missing ``f`` on
``enc_out`` leaves the encoder a partial gradient); the sharded eval
with ``use_pallas_attention`` (K4's plain version on the CPU, once a
decoder layer on the rank's block of heads) against
``make_eval_step``.  Without a world: the head_dim cross route on every
rank of a hand-made group (partial scores summed by hand at S == 1,
gathers and the all-to-all by hand at S > 1), each rank's output
columns against the whole cross-attention's.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as W
from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.schema import tree_map_with_path

LOGIT_RTOL = 1e-4   # of max |logit|: float32, the tensor-parallel partial
#                     sums added in another order
CACHE_RTOL = 1e-5   # of the leaf's max |value|: the same products, the
#                     encoder's sums in another order
LAYER_RTOL = 1e-5   # of max |out|: one layer, float32, two packages
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5     # of the leaf's largest |gradient|
HAND_ATOL = 2e-6    # float32: the partial scores summed in another order

WHISPER = W.WHISPER
WIDE = {"n_heads": 6, "n_kv_heads": 6, "d_model": 384,
        "modality_embed_dim": 384}
# layout -> (mesh spec, world size, mp, the config fields replaced)
LAYOUTS = {"mp2": ("dp=1,mp=2", 2, 2, {}),
           "dp2mp2": ("dp=2,mp=2", 4, 2, {}),
           "mp4": ("dp=1,mp=4", 4, 4, WIDE)}
IDS = list(LAYOUTS)


def _cfg(over):
    return dataclasses.replace(get_config(WHISPER, "smoke"), dtype="float32",
                               **over)


def _ref_cfg(over):
    return dataclasses.replace(ref_config(WHISPER, "smoke"), dtype="float32",
                               **over)


def _prompts():
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(4, 500, size=int(n))))
            for n in (20, 33, 40, 27, 24, 36)]


def _layer_weights(cfg, sig, rng):
    """Seeded numpy weights of one layer of the port's schema (the
    reference's tree): normal of 1 / sqrt(fan in), the ``ones`` leaves 1
    + noise, the ``zeros`` ones noise of 0.1."""
    def draw(path, ps):
        if ps.init == "ones":
            v = 1.0 + rng.normal(0, 0.02, ps.shape)
        elif ps.init in ("zeros", "small"):
            v = rng.normal(0, 0.1, ps.shape)
        else:
            v = rng.normal(0, ps.shape[0] ** -0.5, ps.shape)
        return v.astype(np.float32)
    return tree_map_with_path(draw, T._layer_schema(cfg, sig))


def _layer_inputs(over, rng):
    """Layer 0 of the decoder and of the encoder of whisper SMOKE
    (``over`` replaced), seeded, and their inputs: ``(dec, enc, x,
    enc_out, steps, frames)``."""
    cfg = _cfg(over)
    B, S, T_, d = 2, 8, cfg.encoder_seq_len, cfg.d_model
    dec = _layer_weights(cfg, T.layer_structure(cfg)[1][0], rng)
    enc = _layer_weights(cfg, T.ENC_SIG, rng)
    return (dec, enc, rng.normal(size=(B, S, d)).astype(np.float32),
            rng.normal(size=(B, T_, d)).astype(np.float32),
            rng.normal(size=(B, 2, d)).astype(np.float32),
            rng.normal(size=(B, T_, d)).astype(np.float32))


def _reference_layers(over, dec, enc, x, enc_out, steps, frames):
    """The reference's ``apply_layer`` on :func:`_layer_inputs`: the
    decoder layer's prefill with ``enc_out`` into a cache of 16 rows and
    2 decode steps reading its cross leaves, the encoder layer on the
    frames."""
    rc = _ref_cfg(over)
    B, S, T_ = x.shape[0], x.shape[1], enc_out.shape[1]
    sig = RT.layer_structure(rc)[1][0]
    kv = (B, 16, rc.n_kv_heads, rc.head_dim)
    ckv = (B, T_, rc.n_kv_heads, rc.head_dim)
    cache = {"k": jnp.zeros(kv), "v": jnp.zeros(kv),
             "cross_k": jnp.zeros(ckv), "cross_v": jnp.zeros(ckv)}
    pj = jax.tree_util.tree_map(jnp.asarray, dec)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    y, cache, _ = RT.apply_layer(pj, jnp.asarray(x), rc, sig, positions=pos,
                                 cache=cache, enc_out=jnp.asarray(enc_out))
    outs = [np.asarray(y)]
    for i in range(steps.shape[1]):
        y, cache, _ = RT.apply_layer(
            pj, jnp.asarray(steps[:, i:i + 1]), rc, sig,
            positions=jnp.full((B, 1), S + i, jnp.int32), cache=cache)
        outs.append(np.asarray(y))
    enc_sig = RT.LayerSig("A", 0, False, False, causal=False)
    ye, _, _ = RT.apply_layer(
        jax.tree_util.tree_map(jnp.asarray, enc), jnp.asarray(frames), rc,
        enc_sig, positions=jnp.broadcast_to(jnp.arange(T_, dtype=jnp.int32),
                                            (B, T_)))
    return {"decoder": outs, "encoder": np.asarray(ye),
            "cross": {c: np.asarray(cache[c]) for c in ("cross_k",
                                                        "cross_v")}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One world a layout, the three at once, and the reference's layers
    computed meanwhile."""
    tmp = tmp_path_factory.mktemp("whisper_tp")
    rng = np.random.default_rng(1)
    drng = np.random.default_rng(0)
    layers, runs = {}, {}
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        for lay, (spec, n, _, over) in LAYOUTS.items():
            cfg = _cfg(over)
            T_, d = cfg.encoder_seq_len, cfg.d_model
            layers[lay] = _layer_inputs(over, rng)
            frames = drng.normal(size=(2, T_, d)).astype(np.float32)
            train = {k: drng.integers(4, 512, size=(4, 32)).astype(np.int32)
                     for k in ("tokens", "labels")}
            train["labels"][0, :5] = -1
            train["audio_emb"] = drng.normal(size=(4, T_, d)).astype(
                np.float32)
            evals = {k: drng.integers(4, 512, size=(4, 128)).astype(np.int32)
                     for k in ("tokens", "labels")}
            evals["audio_emb"] = drng.normal(size=(4, T_, d)).astype(
                np.float32)
            runs[lay] = pool.submit(
                W.run_world, W.whisper_tp, n, tmp, spec, [(lay, over)],
                _prompts(), 12, frames, [(lay, over, *layers[lay])],
                [(lay, WHISPER, over, train)], [(lay, WHISPER, over, evals)])
        ref = {lay: _reference_layers(LAYOUTS[lay][3], *args)
               for lay, args in layers.items()}
        port = {lay: run.result() for lay, run in runs.items()}
    return ref, port


@pytest.mark.parametrize("layout", IDS)
def test_whisper_split_serves_the_single_device_tokens(worlds, layout):
    """``ShardedExecutor``'s dense engine, fed tokens alone, as the
    reference's executor serves: the single-device tokens, and the cross
    cache still zero (every score 0, a uniform softmax over zero values,
    a zero cross output, on every rank's split as on one device)."""
    for rank in worlds[1][layout]:
        res = rank["serve"][layout]
        single, got = res["tokens"]
        assert len(single) == 6 and all(len(t) == 12 for t in single)
        assert got == single
        assert res["served_cross"] == 0.0


@pytest.mark.parametrize("layout", IDS)
def test_whisper_split_prefill_with_frames_matches_one_device(worlds,
                                                              layout):
    """A prefill with the frames (the encoder on the rank's split, the
    cross cache written from its output) and 3 decode steps reading the
    cross cache: greedy tokens equal, logits within LOGIT_RTOL."""
    for rank in worlds[1][layout]:
        res = rank["serve"][layout]
        for a, b in zip(res[("greedy", "single")],
                        res[("greedy", "sharded")]):
            np.testing.assert_array_equal(a, b)
        want, got = res[("logits", "single")], res[("logits", "sharded")]
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= LOGIT_RTOL, err


@pytest.mark.parametrize("layout", IDS)
def test_whisper_split_leaves_and_cross_cache_on_each_rank(worlds, layout):
    """The heads placement (mp 2: 4 heads) holds 2 whole heads of every
    attention leaf and of the cross cache a rank; the head_dim one (mp
    4: 6 heads) 16 of 64 columns of every head; ``d_ff`` splits, and
    ``enc_pos`` stays whole.  After the prefill with frames, each rank's
    ``cross_k`` / ``cross_v`` are its heads or columns of the
    single-device cache's."""
    _, _, mp, over = LAYOUTS[layout]
    cfg = _cfg(over)
    H, Dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    on_heads = H % mp == 0
    hl, dl = (H // mp, Dh) if on_heads else (H, Dh // mp)
    for rank in worlds[1][layout]:
        res = rank["serve"][layout]
        sh = res["shapes"]
        for m in ("attn", "cross", "encoder/attn"):
            for w in ("wq", "wk", "wv"):
                assert sh[f"{m}/{w}"][-3:] == (d, hl, dl), (m, w)
            assert sh[f"{m}/wo"][-3:] == (hl, dl, d)
        assert sh["encoder/mlp/w_gate"][-1] == cfg.d_ff // mp
        assert sh["enc_pos"] == (cfg.encoder_seq_len, d)
        for shapes in (sh["cache"], sh["scratch"]):
            for c in ("k", "v", "cross_k", "cross_v"):
                assert shapes[c][-2:] == (hl, dl), (c, shapes[c])
        r = rank["coords"]["model"]
        for c in ("cross_k", "cross_v"):
            want = res[("cross", "single")][c]
            got = res[("cross", "sharded")][c]
            own = (want[..., r * hl:(r + 1) * hl, :] if on_heads
                   else want[..., r * dl:(r + 1) * dl])
            assert np.abs(want).max() > 0
            assert got.shape == own.shape
            assert np.abs(got - own).max() <= CACHE_RTOL * np.abs(
                want).max()


@pytest.mark.parametrize("layout", IDS)
def test_whisper_split_layers_match_the_reference(worlds, layout):
    """One decoder layer (a prefill with ``enc_out`` writing the cross
    leaves, 2 decode steps reading them) and one encoder layer, each
    rank on its cut of seeded weights, against the reference's
    ``apply_layer``; each rank's cross leaves its share of the
    reference's."""
    ref, port = worlds
    want = ref[layout]
    _, _, mp, over = LAYOUTS[layout]
    cfg = _cfg(over)
    on_heads = cfg.n_heads % mp == 0
    hl, dl = cfg.n_kv_heads // mp, cfg.head_dim // mp
    for rank in port[layout]:
        got = rank["layer"][layout]
        assert len(got["decoder"]) == 3
        for g, w in zip(got["decoder"] + [got["encoder"]],
                        want["decoder"] + [want["encoder"]]):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= LAYER_RTOL * np.abs(w).max()
        r = rank["coords"]["model"]
        for c, w in want["cross"].items():
            own = (w[..., r * hl:(r + 1) * hl, :] if on_heads
                   else w[..., r * dl:(r + 1) * dl])
            assert np.abs(got["cross"][c] - own).max() <= (
                LAYER_RTOL * np.abs(w).max())


@pytest.mark.parametrize("layout", IDS)
def test_whisper_split_loss_and_gradients_match_one_device(worlds, layout):
    cfg = _cfg(LAYOUTS[layout][3])
    names = []
    tree_map_with_path(lambda path, ps: names.append("/".join(
        map(str, path))), build_model(cfg).schema)
    for rank in worlds[1][layout]:
        res = rank["train"][layout]
        loss, sloss = res["loss"]
        assert sloss == pytest.approx(loss, rel=LOSS_RTOL)
        grads = res["grads"]
        assert sorted(grads) == sorted(names)
        for name, (g, s) in grads.items():
            assert s.shape == g.shape, name
            bar = GRAD_TOL * np.abs(g).max()
            assert np.abs(s - g).max() <= bar, (name, np.abs(s - g).max(),
                                                bar)
        # the encoder's leaves get the cross sublayers' parts through f
        for leaf in ("enc_pos", "encoder/attn/wq", "encoder/mlp/w_down",
                     "encoder/ln1", "enc_final_norm",
                     "blocks/p0/cross/wk", "blocks/p0/cross/wv"):
            assert np.abs(grads[leaf][0]).max() > 0, leaf


@pytest.mark.parametrize("layout", IDS)
def test_whisper_split_eval_takes_k4_on_the_rank_heads(worlds, layout):
    """``make_sharded_eval_step`` with ``use_pallas_attention``: the loss
    of ``make_eval_step``, K4 (its plain version here) once a causal
    decoder layer on the rank's block of heads (the encoder's
    non-causal layers take the plain attention, as in the reference);
    on the head_dim route its q is a view of the rank's heads of every
    head's rotated rows."""
    spec, n, mp, over = LAYOUTS[layout]
    cfg = _cfg(over)
    H = cfg.n_heads
    rows = 4 // (n // mp)
    for rank in worlds[1][layout]:
        res = rank["eval"][layout]
        loss, sloss = res["loss"]
        assert np.isfinite(loss)
        assert sloss == pytest.approx(loss, rel=LOSS_RTOL)
        assert [c[0] for c in res["single_calls"]] == [
            (4, 128, H, cfg.head_dim)] * cfg.n_layers
        r = rank["coords"]["model"]
        count = L._heads_of(H, mp, r)[1][r]
        shapes = [c[0] for c in res["calls"]]
        assert shapes == [(rows, 128, count, cfg.head_dim)] * cfg.n_layers
        if H % mp:
            # a view: this rank's heads of the (B, S, H, D) rows
            assert all(c[1][1] == H * cfg.head_dim for c in res["calls"])


# ---------------------------------------------------------------------------
# The head_dim cross route by hand: no world
# ---------------------------------------------------------------------------


class _Hub:
    """n ranks in threads, each handing in a tensor and getting every
    rank's back in rank order."""

    def __init__(self, n):
        self.n, self.parts = n, [None] * n
        self.barrier = threading.Barrier(n)

    def exchange(self, r, x):
        self.parts[r] = x
        self.barrier.wait()
        got = list(self.parts)
        self.barrier.wait()
        return got


class _Group:
    def __init__(self, hub, r):
        self.hub, self.r = hub, r


@pytest.fixture
def hand_group(monkeypatch):
    """``models/layers.py``'s collectives done by hand over a
    :class:`_Hub`: the sum in rank order, the gathers concatenated in
    rank order, the all-to-all's blocks; each call counted by kind."""
    issued = {"all_reduce": 0, "gather": 0, "all_to_all": 0}
    lock = threading.Lock()

    def count(kind):
        with lock:
            issued[kind] += 1

    def all_reduce(x, g):
        if g is None:
            return x
        count("all_reduce")
        parts = g.hub.exchange(g.r, x)
        total = parts[0].clone()
        for p in parts[1:]:
            total = total + p
        return total

    def gather_split(x, g, dim):
        count("gather")
        return torch.cat(g.hub.exchange(g.r, x), dim)

    def all_to_all(x, g, sizes=None, out_sizes=None):
        count("all_to_all")
        return torch.cat([p.split(ps)[g.r]
                          for p, ps in g.hub.exchange(g.r, (x, sizes))])
    monkeypatch.setattr(L, "all_reduce", all_reduce)
    monkeypatch.setattr(L, "gather_split", gather_split)
    monkeypatch.setattr(L, "all_to_all", all_to_all)
    monkeypatch.setattr(L.dist, "get_world_size", lambda g: g.hub.n)
    monkeypatch.setattr(L.dist, "get_rank", lambda g: g.r)
    return issued


def _threads(n, body):
    outs = [None] * n
    errs = []

    def run(r):
        try:
            outs[r] = body(r)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)
            raise
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs
    return outs


@pytest.mark.parametrize("S", [1, 5], ids=["decode", "prefill"])
def test_head_dim_cross_route_gives_each_rank_its_columns(hand_group, S):
    """6 heads and kv heads of 64 over 4 ranks (16 columns a rank), 12
    encoder rows: at S == 1 each rank's columns of q against its columns
    of the cross k / v, the float32 partial scores summed (one sum a
    rank); at S > 1 q, k and v gathered in one all-gather, the rank's
    block of heads (2, 2, 1, 1) attended whole and returned by one
    all-to-all.  Each rank's output columns equal the whole
    cross-attention's, and ``gqa_apply`` with the rank's ``wq`` / ``wo``
    cut gives the whole layer's output after ``wo``'s sum."""
    cfg = _cfg(WIDE)
    n, B, T = 4, 2, 12
    H, Dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    Dl = Dh // n
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(B, S, d)).astype(np.float32))
    wq = torch.from_numpy(rng.normal(0, d ** -0.5, (d, H, Dh)).astype(
        np.float32))
    wo = torch.from_numpy(rng.normal(0, (H * Dh) ** -0.5, (H, Dh, d)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, T, H, Dh)).astype(
        np.float32)) for _ in range(2))
    pos = torch.arange(7, 7 + S, dtype=torch.int32)[None].expand(B, S)
    q = L.proj_heads(x, wq)
    whole = L.attention(q, k, v, q_pos=pos, causal=False)
    layer = L.gqa_apply({"wq": wq, "wo": wo}, x, cfg, positions=pos,
                        cross_kv=(k, v))[0]
    hub = _Hub(n)

    def rank(r):
        g, dims = _Group(hub, r), slice(r * Dl, (r + 1) * Dl)
        out = L._gqa_head_dim(q[..., dims], k[..., dims], v[..., dims], cfg,
                              positions=pos, cache=None, window=0,
                              causal=False, ring=False, page_table=None,
                              tp=g, cross=True)
        y = L.gqa_apply({"wq": wq[..., dims].contiguous(),
                         "wo": wo[:, dims].contiguous()}, x, cfg,
                        positions=pos, cross_kv=(k[..., dims],
                                                 v[..., dims]), tp=g)[0]
        return out, y
    outs = _threads(n, rank)
    for r, (out, y) in enumerate(outs):
        assert out.shape == (B, S, H, Dl)
        np.testing.assert_allclose(out.numpy(),
                                   whole[..., r * Dl:(r + 1) * Dl].numpy(),
                                   atol=HAND_ATOL)
        np.testing.assert_allclose(y.numpy(), layer.numpy(), atol=HAND_ATOL)
    # each rank, twice (the route alone, then gqa_apply): at decode one
    # sum of the scores a call, and wo's; at S > 1 one gather and one
    # all-to-all a call, and wo's sum
    want = ({"all_reduce": 2 * n + n, "gather": 0, "all_to_all": 0}
            if S == 1 else {"all_reduce": n, "gather": 2 * n,
                            "all_to_all": 2 * n})
    assert hand_group == want


def test_gather_heads_joins_parts_of_other_lengths(hand_group):
    """The route's gather: q (B, S, H, Dl) beside the encoder's k and v
    (B, T, Hkv, Dl), flattened into one all-gather, each whole on
    head_dim in rank order; parts of one length (the self-attention's)
    take the same path."""
    n, B, S, T, H, Dl = 4, 2, 3, 5, 2, 4
    rng = np.random.default_rng(4)
    full = [torch.from_numpy(rng.normal(size=(B, s, H, Dl * n)).astype(
        np.float32)) for s in (S, T, T)]
    hub = _Hub(n)

    def rank(r):
        dims = slice(r * Dl, (r + 1) * Dl)
        g = _Group(hub, r)
        return (L._gather_heads([t[..., dims] for t in full], g),
                L._gather_heads([t[..., dims] for t in full[1:]], g))
    for mixed, same in _threads(n, rank):
        for got, want in zip(mixed, full):
            assert torch.equal(got, want)
        for got, want in zip(same, full[1:]):
            assert torch.equal(got, want)
    assert hand_group["gather"] == 2 * n


def test_mixed_cross_placement_raises(hand_group):
    """q on heads with the cross k / v on head_dim (H != Hkv, which no
    published Whisper has) is refused by name, not guessed."""
    cfg = _cfg({})
    q = torch.zeros(1, 3, 2, cfg.head_dim)
    k = torch.zeros(1, 5, 1, cfg.head_dim // 2)
    with pytest.raises(ValueError, match="cross-attention with q on heads"):
        L._gqa_head_dim(q, k, k, cfg, positions=None, cache=None, window=0,
                        causal=False, ring=False, page_table=None,
                        tp=_Group(_Hub(2), 0), cross=True)


@pytest.mark.parametrize("entry", ["train_logits", "prefill"])
def test_encoder_output_passes_f_once(monkeypatch, entry):
    """The encoder's output goes through ``f`` (``copy_to_split``) once,
    where it leaves ``_encode``, and every decoder layer's cross sublayer
    projects it as it is: under training's ``GradGroup`` the layers'
    gradients into it are summed on the rank and all-reduced once, not
    once a layer."""
    cfg = _cfg({})
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    rng = np.random.default_rng(5)
    B = 2
    inputs = {"tokens": torch.from_numpy(rng.integers(
                  4, cfg.vocab_size, size=(B, 6))),
              "audio_emb": torch.from_numpy(rng.normal(size=(
                  B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))}
    shape = (B, cfg.encoder_seq_len, cfg.d_model)
    seen = []
    real = T.copy_to_split

    def counted(x, tp):
        if tuple(x.shape) == shape:
            seen.append(tp)
        return real(x, tp)
    monkeypatch.setattr(T, "copy_to_split", counted)
    with torch.no_grad():
        if entry == "train_logits":
            model.train_logits(params, inputs)
        else:
            model.prefill(params, inputs, model.init_cache(B, 8,
                                                           device="cpu"))
    assert cfg.n_layers > 1 and seen == [None]
