"""Spawned gloo worlds for the port's multi-process tests.

``run_world(fn, n, tmp_path, *args)`` starts ``n`` processes with the
``spawn`` start method.  Each joins a gloo process group through a
``file://`` store under ``tmp_path`` (no fixed port, so parallel test
workers never meet), caps torch at one intra-op thread, runs
``fn(rank, *args)``, pickles its result into ``tmp_path`` and exits
without the interpreter's teardown.  A rank that raises fails the test
with its traceback, one that dies otherwise with its exit code; a world
still running
after ``timeout`` seconds (a rank hung in a collective) is killed and
fails the test.  The process group's own ``timeout`` is shorter, so a
lost peer surfaces as a raise first.

The worker bodies live here too: a spawned process imports torch, numpy
and the port, never JAX; the tests hand it the reference's weights as
numpy arrays and hold its results against the reference's in the parent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pickle
import sys
import traceback
from datetime import timedelta

import numpy as np

WORLD_TIMEOUT_S = 240
PG_TIMEOUT_S = 120

QWEN = "qwen1.5-32b"
# the reference's sharded-executor tests' engines
# (tests/test_sharded_executor.py, tests/test_paged_engine.py)
DENSE_KW = dict(num_slots=4, max_len=64, max_new_cap=16, sync_every=4,
                prefill_batch=4)
PAGED_KW = dict(num_slots=4, max_len=64, max_new_cap=16, sync_every=4,
                prefill_batch=2, paged=True, page_size=8)
CHAOS_KW = dict(num_slots=4, max_len=64, max_new_cap=16, sync_every=2,
                prefill_batch=2)
FAMILY_KW = dict(num_slots=4, max_len=48, max_new_cap=8, sync_every=4,
                 prefill_batch=2)


def _entry(rank, n, store, out_dir, fn, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n,
                                timeout=timedelta(seconds=PG_TIMEOUT_S))
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    # the results are written: leave without the interpreter's teardown,
    # where gloo's threads can still abort the process (std::terminate)
    # on a loaded host and fail a world whose every rank finished
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_world(fn, n: int, tmp_path, *args, timeout: float = WORLD_TIMEOUT_S):
    """Every rank's ``fn(rank, *args)`` over a gloo world of ``n``."""
    import multiprocessing as mp
    import time
    ctx = mp.get_context("spawn")
    out_dir = tmp_path / f"world-{fn.__name__}-{n}-{time.monotonic_ns()}"
    out_dir.mkdir()
    store = out_dir / "store"
    procs = [ctx.Process(target=_entry,
                         args=(r, n, str(store), str(out_dir), fn, args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [i for i, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = {r: (out_dir / f"rank{r}.err").read_text() for r in range(n)
            if (out_dir / f"rank{r}.err").exists()}
    if errs:
        raise AssertionError("\n".join(f"rank {r}:\n{t}"
                                       for r, t in errs.items()))
    if hung:
        raise AssertionError(f"ranks {hung} still running after "
                             f"{timeout} s: killed")
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if bad:
        raise AssertionError(f"exit codes {bad}")
    return [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes())
            for r in range(n)]


# ---------------------------------------------------------------------------
# Worker bodies
# ---------------------------------------------------------------------------


def _model(arch: str, np_params=None, **over):
    """A float32 SMOKE model and its params on the host: ``np_params``
    (the reference's, as numpy) bridged, or the port's seeded draw."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                              **over)
    model = build_model(cfg)
    params = (model.init(seed=0, device="cpu") if np_params is None
              else params_from_numpy(np_params, device="cpu"))
    return cfg, model, params


def _tokens(gens):
    return [[int(t) for t in g.tokens] for g in gens]


def _record_prefill_rows(model) -> list:
    """Wrap ``model.prefill`` (on the instance): the row count of each
    call is appended to the list returned."""
    seen, real = [], model.prefill

    def prefill(params, inputs, cache, **kw):
        seen.append(int(inputs["tokens"].shape[0]))
        return real(params, inputs, cache, **kw)
    model.prefill = prefill
    return seen


def _record_borrows(ex) -> list:
    """Wrap ``ex.admit_paged`` (on the instance): for each admission, the
    blocks of the rows this rank prefills whose shared page another
    rank's partition holds."""
    seen, real = [], ex.admit_paged
    per = ex.num_pages // ex.page_partitions

    def admit_paged(*args):
        src = np.asarray(args[-1])[ex.prefill_rows]
        seen.append(int(((src < ex.num_pages)
                         & (src // per != ex.mesh.batch_index)).sum()))
        return real(*args)
    ex.admit_paged = admit_paged
    return seen


def _cache_shapes(ex, mesh) -> dict:
    """The executor's slot cache and prefill scratch leaf shapes, each
    beside the local shapes ``launch/specs.py::cache_specs_at`` gives on
    ``mesh`` (the slot cache's only where it is dense)."""
    from repro_torch.launch.specs import cache_specs_at
    from repro_torch.models.schema import tree_leaves
    cfg = ex.model.cfg

    def spec(batch):
        return [s.local for s in tree_leaves(
            cache_specs_at(cfg, batch, ex.max_len, mesh))]
    out = {"scratch": ([tuple(t.shape) for t in tree_leaves(ex._pcache)],
                       spec(ex.prefill_batch))}
    if not ex.paged:
        out["cache"] = ([tuple(t.shape) for t in tree_leaves(ex._cache)],
                        spec(ex.num_slots))
    return out


def serve_layout(rank, spec, np_params, dense_prompts, paged_prompts,
                 logit_tokens, int8):
    """One layout of qwen SMOKE: the dense engine on the reference
    test's prompts, the paged engine on its prefix-sharing prompts (two
    waves; with ``int8`` also over the int8 pool), the layout the
    executor took, and, with ``logit_tokens``, the prefill and one
    decode step's logits through the sharded model."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import build_model
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.executor import ShardedExecutor
    cfg, model, params = _model(QWEN, np_params)
    mesh = make_serving_mesh(spec, cfg, device="cpu")
    out = {"coords": dict(mesh.coords), "batch_index": mesh.batch_index}
    rows = _record_prefill_rows(model)
    eng = ContinuousEngine(model, params, mesh=mesh, **DENSE_KW)
    ex = eng.executor
    out["dense"] = _tokens(eng.generate_many(dense_prompts, 12))
    out["dense_allocs"] = eng.stats.cache_allocations
    out["dense_rows"] = list(rows)
    out["dense_shapes"] = _cache_shapes(ex, mesh)
    out["slot_base"], out["slots_here"] = ex.slot_base, ex._dactive.shape[0]
    out["cache_k"] = tuple(ex._cache["blocks"]["p0"]["k"].shape)
    out["scratch_k"] = tuple(ex._pcache["blocks"]["p0"]["k"].shape)
    out["params"] = {name: tuple(leaf.shape) for name, leaf in (
        ("wq", ex.params["blocks"]["p0"]["attn"]["wq"]),
        ("w_gate", ex.params["blocks"]["p0"]["mlp"]["w_gate"]),
        ("embed", ex.params["embed"]))}
    # mp = 1 keeps every leaf as it came, a view of the caller's
    out["shared_embed"] = (ex.params["embed"].data_ptr()
                           == params["embed"].data_ptr())
    for quant in (False, True) if int8 else (False,):
        qmodel = build_model(dataclasses.replace(cfg, kv_quant_int8=quant))
        rows = _record_prefill_rows(qmodel)
        eng = ContinuousEngine(qmodel, params, mesh=mesh, **PAGED_KW)
        borrows = _record_borrows(eng.executor)
        tag = "paged_int8" if quant else "paged"
        out[tag] = [_tokens(eng.generate_many(paged_prompts, 12))
                    for _ in range(2)]
        out[tag + "_rows"], out[tag + "_borrows"] = rows, borrows
        out[tag + "_shapes"] = _cache_shapes(eng.executor, mesh)
        out[tag + "_stats"] = dict(
            avoided=eng.stats.prefill_tokens_avoided,
            allocs=eng.stats.cache_allocations,
            partitions=eng._pages.partitions,
            pool=tuple(eng.executor._cache["blocks"]["p0"][
                "k_q" if quant else "k"].shape),
            table=tuple(eng.executor._cache["table"].shape),
            page_base=eng.executor.page_base)
    if logit_tokens is not None:
        toks = torch.from_numpy(np.asarray(logit_tokens, np.int64))
        ex = ShardedExecutor(model, params, mesh=mesh, num_slots=4,
                             max_len=64, prefill_batch=toks.shape[0])
        with torch.no_grad():
            pre, _ = model.prefill(ex.params, {"tokens": toks}, ex._pcache,
                                   tp=ex.tp)
            nxt = pre[:, -1].argmax(-1)
            dec, _ = model.decode(ex.params, {"tokens": nxt[:, None]},
                                  ex._pcache, tp=ex.tp)
        out["logits"] = (pre.numpy(), dec.numpy())
    return out


def serve_families(rank, spec, archs, prompts):
    """Each SMOKE family's dense engine tokens on one device and over the
    mesh, and a ``ValueError``'s text where the mesh refuses it."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.continuous import ContinuousEngine
    out = {}
    mesh = make_serving_mesh(spec, device="cpu")
    for arch in archs:
        _, model, params = _model(arch)
        single = ContinuousEngine(model, params, **FAMILY_KW)
        want = _tokens(single.generate_many(prompts, 8))
        try:
            eng = ContinuousEngine(model, params, mesh=mesh, **FAMILY_KW)
        except ValueError as exc:
            out[arch] = ("refused", str(exc))
            continue
        rows = _record_prefill_rows(model)
        out[arch] = ("served", want, _tokens(eng.generate_many(prompts, 8)))
        out[arch + "_rows"] = rows
    return out


def chaos_run(rank, spec, np_params, prompts, questions):
    """The reference's chaos plans (tests/test_sharded_executor.py) on
    the engine over the mesh and on one device: a NaN on slot 2, then a
    transient decode fault requeued once; and the NaN plan through
    ``Gateway.serve`` (closed loop, retries) over
    ``ContinuousEngineBackend``, its ``GatewayStats``."""
    from repro_torch.core.config import RetrievalConfig, RouterConfig
    from repro_torch.data import HashTokenizer, SyntheticSquad
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.retrieval import BM25Index
    from repro_torch.routing import (ContinuousEngineBackend, FixedPolicy,
                                     Gateway, Request)
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.faults import (ChaosInjector, FaultPlan,
                                            FaultSpec, RetryPolicy)
    cfg, model, params = _model(QWEN, np_params)
    mesh = make_serving_mesh(spec, cfg, device="cpu")
    nan = FaultPlan(specs=(FaultSpec(site="executor.decode", kind="nan",
                                     start=1, count=1, slots=(2,)),))
    fault = FaultPlan(specs=(FaultSpec(site="executor.decode",
                                       kind="raise", start=1, count=1),))
    data = SyntheticSquad(n_paragraphs=40, n_questions=questions, seed=0)
    index = BM25Index.build([p.text for p in data.paragraphs],
                            RetrievalConfig(vocab_hash_dim=1024))

    def run(m):
        def build(chaos=None, **kw):
            return ContinuousEngine(model, params, mesh=m, chaos=chaos,
                                    **CHAOS_KW, **kw)
        res = {"clean": _tokens(build().generate_many(prompts, 10))}
        eng = build(ChaosInjector(nan))
        rids = [eng.reserve_rid() for _ in prompts]
        for rid, p in zip(rids, prompts):
            eng.submit(rid, p, 10)
        done = eng.run()
        outs = [done[r] for r in rids]
        res["nan"] = ([(o.failed, o.transient, [int(t) for t in o.tokens])
                       for o in outs], eng.stats.n_nan_trips,
                      sorted(eng.quarantined_slots), eng.reset_quarantine(),
                      _tokens(eng.generate_many(prompts[:2], 6)))
        eng = build(ChaosInjector(fault), max_requeues=1)
        res["fault"] = (_tokens(eng.generate_many(prompts, 10)),
                        eng.stats.n_exec_faults, eng.stats.n_requeued)
        backend = ContinuousEngineBackend.create(
            model, params, HashTokenizer(cfg.vocab_size), index,
            num_slots=4, max_prompt_len=48, max_new_tokens=8, sync_every=2,
            chaos=ChaosInjector(nan), mesh=m)
        gw = Gateway(FixedPolicy(2), backend, router_cfg=RouterConfig(),
                     index=index, max_batch=8, adaptive_refusal=False,
                     retry=RetryPolicy(max_retries=2, backoff_s=0.0),
                     sleep=lambda s: None, clock=lambda: 0.0)
        st = gw.serve([Request(qid=q.qid, question=q, slo="quality_first")
                       for q in data.questions])
        res["gateway"] = {
            f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if f.name not in ("decisions", "latency")}
        res["gateway"]["action_counts"] = dict(st.action_counts)
        res["gateway_engine"] = (backend.engine.stats.n_nan_trips,
                                 backend.engine.stats.n_quarantined)
        return res

    return {"single": run(None), "sharded": run(mesh)}


def serve_cli(rank, argv, size):
    """``repro_torch.launch.serve.main(argv)`` on a testbed of ``size``
    (patched through the module's ``TestbedConfig`` name), its standard
    output captured."""
    from repro_torch.core.config import RouterConfig, TestbedConfig
    from repro_torch.launch import serve
    n_epochs = size.pop("n_epochs")
    serve.TestbedConfig = lambda: TestbedConfig(
        **size, router=RouterConfig(n_epochs=n_epochs))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = serve.main(argv)
    return {"out": buf.getvalue(), "served": run["stats"].served}


def retrieval(rank, spec, tf, doc_len, idf, qtf, emb, qe, k):
    """The distributed BM25 and dense top-k over the mesh: the
    functions on the whole corpus and the classes over their shards."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.retrieval import (DistributedBM25,
                                       DistributedDenseIndex,
                                       distributed_bm25_topk,
                                       distributed_dense_topk)
    mesh = make_serving_mesh(spec, device="cpu")
    t = torch.from_numpy
    qv = t(qtf * idf[None, :])
    bs, bi = distributed_bm25_topk(mesh, t(tf), t(doc_len), qv, k=k)
    ds, di = distributed_dense_topk(mesh, t(emb), t(qe), k=k)
    ci, cs = DistributedBM25(mesh, tf, doc_len, idf).topk(qtf, k=k)
    ei, es = DistributedDenseIndex(mesh, emb).topk(qe, k=k)
    return {"bm25": (bi.numpy(), bs.numpy()), "dense": (di.numpy(),
                                                        ds.numpy()),
            "bm25_class": (ci, cs), "dense_class": (ei, es)}


# the head_dim route's engines: prompts of 20-40 tokens and 12 new ones
# run past gemma3 SMOKE's window of 32 (and around its ring); the paged
# prompts share a 16-token prefix, so suffix prefills attend over
# gathered shared pages
HEAD_DIM_KW = dict(num_slots=4, max_len=64, max_new_cap=16, sync_every=4,
                   prefill_batch=2)
HEAD_DIM_PAGED_KW = dict(HEAD_DIM_KW, paged=True, page_size=8)


def serve_head_dim(rank, spec, cases, prompts, new_tokens):
    """Each case ``(key, arch, over)`` (a float32 SMOKE config with the
    fields ``over`` replaces, its seeded weights): the single-device
    engine's tokens and the tokens over the mesh ``spec``, dense, paged
    and paged int8 (dense only where ``over`` asks for the ring cache,
    which never pages), the rank's local wq, wk, cache and prefill
    scratch shapes, and
    the logits of a prefill of the first two prompts and 3 greedy decode
    steps on one device and through the sharded model, over the dense
    cache and its int8 form."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.schema import zeros_from_schema
    from repro_torch.serving.executor import ShardedExecutor
    from repro_torch.models import build_model
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.sharding import local_schema, specs_for_schema
    mesh = make_serving_mesh(spec, device="cpu")
    out = {"coords": dict(mesh.coords)}
    for key, arch, over in cases:
        cfg, model, params = _model(arch, **over)
        engines = {"dense": (model, HEAD_DIM_KW)}
        if not cfg.window_ring_cache:
            engines["paged"] = (model, HEAD_DIM_PAGED_KW)
            engines["paged_int8"] = (build_model(dataclasses.replace(
                cfg, kv_quant_int8=True)), HEAD_DIM_PAGED_KW)
        res = {}
        for name, (m, kw) in engines.items():
            single = _tokens(ContinuousEngine(m, params, **kw)
                             .generate_many(prompts, new_tokens))
            eng = ContinuousEngine(m, params, mesh=mesh, **kw)
            res[name] = (single, _tokens(eng.generate_many(prompts,
                                                           new_tokens)))
            ex = eng.executor
            res[name + "_shapes"] = {
                "wq": tuple(ex.params["blocks"]["p0"]["attn"]["wq"].shape),
                "wk": tuple(ex.params["blocks"]["p0"]["attn"]["wk"].shape),
                "cache": {c: tuple(t.shape) for c, t in
                          ex._cache["blocks"]["p0"].items()},
                "scratch": {c: tuple(t.shape) for c, t in
                            ex._pcache["blocks"]["p0"].items()}}
        n = min(len(p) for p in prompts[:2])
        toks = torch.tensor([p[:n] for p in prompts[:2]])
        for quant in (False, True):
            m = build_model(dataclasses.replace(cfg, kv_quant_int8=quant))
            ex = ShardedExecutor(m, params, mesh=mesh, num_slots=2,
                                 max_len=64)
            # both rows through this rank's kv heads (the executor's
            # scratch holds only its share of the rows)
            schema = m.cache_schema(2, 64)
            scratch = zeros_from_schema(local_schema(
                schema, specs_for_schema(schema, mesh), mesh,
                axes=("model",)), device="cpu")
            runs = {"single": (params, m.init_cache(2, 64, device="cpu"),
                               None),
                    "sharded": (ex.params, scratch, ex.tp)}
            for name, (p, cache, tp) in runs.items():
                with torch.no_grad():
                    lg, cache = m.prefill(p, {"tokens": toks}, cache, tp=tp)
                    got = [lg.numpy()]
                    for _ in range(3):
                        nxt = lg[:, -1].argmax(-1)[:, None]
                        lg, cache = m.decode(p, {"tokens": nxt}, cache,
                                             tp=tp)
                        got.append(lg.numpy())
                res[("logits", quant, name)] = got
        out[key] = res
    return out


# the MLA route's engines: prompts of 20-40 tokens and 12 new ones on
# the dense slot cache (MLA never pages)
MLA_KW = dict(num_slots=4, max_len=64, max_new_cap=16, sync_every=4,
              prefill_batch=2)


def serve_mla(rank, spec, cases, prompts, new_tokens):
    """Each case ``(key, arch, over)`` (a float32 SMOKE config with the
    fields ``over`` replaces, its seeded weights), naive and absorbed:
    the single-device dense engine's tokens and the tokens over the mesh
    ``spec``, the rank's local ``wq_b`` / ``wk_b`` / ``wo`` and cache
    and prefill scratch shapes, the slot cache's rows after the serve
    (its ``c_kv`` columns here, its ``k_rope``), and the logits of a
    prefill of the first two prompts and 3 greedy decode steps on one
    device and through the sharded model."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.schema import zeros_from_schema
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.sharding import local_schema, specs_for_schema
    mesh = make_serving_mesh(spec, device="cpu")
    out = {"coords": dict(mesh.coords)}
    n = min(len(p) for p in prompts[:2])
    toks = torch.tensor([p[:n] for p in prompts[:2]])
    for key, arch, over in cases:
        cfg, model, params = _model(arch, **over)
        res = {}
        for absorb in (False, True):
            single = ContinuousEngine(model, params, mla_absorb=absorb,
                                      **MLA_KW)
            want = _tokens(single.generate_many(prompts, new_tokens))
            eng = ContinuousEngine(model, params, mesh=mesh,
                                   mla_absorb=absorb, **MLA_KW)
            res[("tokens", absorb)] = (want, _tokens(
                eng.generate_many(prompts, new_tokens)))
            ex, sx = eng.executor, single.executor
            attn = ex.params["blocks"]["p0"]["attn"]
            res["shapes"] = {
                **{w: tuple(attn[w].shape) for w in ("wq_b", "wk_b",
                                                     "wv_b", "wo")},
                "cache": {c: tuple(t.shape) for c, t in
                          ex._cache["blocks"]["p0"].items()},
                "scratch": {c: tuple(t.shape) for c, t in
                            ex._pcache["blocks"]["p0"].items()}}
            lo = ex.slot_base
            rows = slice(lo, lo + ex._dactive.shape[0])
            res[("cache", absorb)] = {
                c: (sx._cache["blocks"]["p0"][c][:, rows].numpy(),
                    ex._cache["blocks"]["p0"][c].numpy())
                for c in ("c_kv", "k_rope")}
            # every row on each rank, its kv_lora columns of the cache
            schema = model.cache_schema(2, 64)
            local = zeros_from_schema(local_schema(
                schema, specs_for_schema(schema, mesh), mesh, ("model",)),
                device="cpu")
            runs = {"single": (params, model.init_cache(2, 64, device="cpu"),
                               None),
                    "sharded": (ex.params, local, ex.tp)}
            for name, (p, cache, tp) in runs.items():
                with torch.no_grad():
                    lg, cache = model.prefill(p, {"tokens": toks}, cache,
                                              tp=tp, mla_absorb=absorb)
                    got = [lg.numpy()]
                    for _ in range(3):
                        nxt = lg[:, -1].argmax(-1)[:, None]
                        lg, cache = model.decode(p, {"tokens": nxt}, cache,
                                                 tp=tp, mla_absorb=absorb)
                        got.append(lg.numpy())
                res[("logits", absorb, name)] = got
        out[key] = res
    return out


def mla_layer(rank, spec, cases):
    """Each case ``(key, arch, over, np_params, x, steps, absorb,
    max_len)``: one MLA layer of the float32 SMOKE config over the mesh
    ``spec``, on this rank's cut of the whole layer ``np_params`` (the
    resolver's serving placement) and its ``kv_lora`` columns of a
    ``max_len``-row cache: a prefill of ``x`` (B, S, d), then one decode
    step a column of ``steps`` (B, n, d).  Returns each call's output."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.schema import ParamSpec, zeros_from_schema
    from repro_torch.sharding import (local_params, local_schema,
                                      specs_for_schema)
    mesh = make_serving_mesh(spec, device="cpu")
    tp = mesh.group("model")
    out = {}
    for key, arch, over, p, x, steps, absorb, max_len in cases:
        cfg = dataclasses.replace(get_config(arch, "smoke"),
                                  dtype="float32", **over)
        m = cfg.mla
        schema = L.mla_schema(cfg)
        params = local_params(
            schema, {k: torch.from_numpy(v) for k, v in p.items()}, mesh,
            specs_for_schema(schema, mesh, fsdp=False))
        B, S = x.shape[:2]
        cs = {"c_kv": ParamSpec((B, max_len, m.kv_lora_rank),
                                ("batch", "seq", "kv_lora"), "float32",
                                "zeros"),
              "k_rope": ParamSpec((B, max_len, m.qk_rope_head_dim),
                                  ("batch", "seq", ""), "float32",
                                  "zeros")}
        cache = zeros_from_schema(local_schema(
            cs, specs_for_schema(cs, mesh), mesh, ("model",)), device="cpu")
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        with torch.no_grad():
            y, _ = L.mla_apply(params, torch.from_numpy(x), cfg,
                               positions=pos, cache=cache, absorb=absorb,
                               tp=tp)
            got = [y.numpy()]
            for i in range(steps.shape[1]):
                y, _ = L.mla_apply(
                    params, torch.from_numpy(steps[:, i:i + 1].copy()), cfg,
                    positions=torch.full((B, 1), S + i, dtype=torch.int32),
                    cache=cache, absorb=absorb, tp=tp)
                got.append(y.numpy())
        out[key] = got
    return out
