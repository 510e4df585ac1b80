"""``Gateway.serve`` end to end in both packages on qwen SMOKE float32:
the same corpus and questions, BM25 index, weights (bridged) and
requests give identical routed actions, answers, rewards and
``GatewayStats`` — once under the paper's fixed baseline
``FixedPolicy(0)`` (k=2, guarded) and once under the MLP policy trained
by the reference, its params carried across by the bridge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.config import TestbedConfig
from repro.core.offline_log import build_testbed
from repro.core.policy import train_policy
from repro.data.tokenizer import HashTokenizer as RefTokenizer
from repro.models import build_model as ref_build
from repro.retrieval.hybrid import IndexRetriever
from repro.routing import ContinuousEngineBackend as RefBackend
from repro.routing import FixedPolicy as RefFixed
from repro.routing import Gateway as RefGateway
from repro.routing import MLPPolicy as RefMLP
from repro.routing import Request as RefRequest
from repro.routing.registry import get_slo_profile as ref_profile
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import RetrievalConfig, RouterConfig
from repro_torch.data import HashTokenizer, SyntheticSquad
from repro_torch.models import build_model
from repro_torch.retrieval import BM25Index
from repro_torch.routing import (ContinuousEngineBackend, FixedPolicy,
                                 Gateway, MLPPolicy, Request)

ENGINE = dict(num_slots=4, max_prompt_len=96, max_new_tokens=4,
              prefill_batch=2)


@pytest.fixture(scope="module")
def setup():
    # a small testbed; its trained router sends some of the last 12
    # questions to a0 (generate) and some to a4 (refuse)
    tcfg = TestbedConfig(n_train=40, n_eval=16, n_paragraphs=60)
    data, index, _pipe, train_log, _eval = build_testbed(tcfg)
    ported = SyntheticSquad(n_paragraphs=tcfg.n_paragraphs,
                            n_questions=tcfg.n_train + tcfg.n_eval,
                            answerable_frac=tcfg.answerable_frac,
                            seed=tcfg.seed)
    tindex = BM25Index.build([p.text for p in ported.paragraphs],
                             RetrievalConfig())
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    rm, tm = ref_build(rc), build_model(tc)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       rm.init(jax.random.PRNGKey(0)))
    ref_backend = RefBackend.create(
        rm, jax.tree_util.tree_map(jnp.asarray, np_params),
        RefTokenizer(rc.vocab_size), index, **ENGINE)
    port_backend = ContinuousEngineBackend.create(
        tm, params_from_numpy(np_params, device="cpu"),
        HashTokenizer(tc.vocab_size), tindex, **ENGINE)
    trained = train_policy(train_log,
                           train_log.rewards(ref_profile("quality_first")),
                           tcfg.router, objective="argmax_ce")
    return dict(data=data, index=index, ported=ported, tindex=tindex,
                ref_backend=ref_backend, port_backend=port_backend,
                trained=trained, router=tcfg.router)


def test_corpus_questions_and_index_identical(setup):
    data, ported = setup["data"], setup["ported"]
    assert [(p.pid, p.subject, p.text) for p in ported.paragraphs] == \
        [(p.pid, p.subject, p.text) for p in data.paragraphs]
    assert [dataclasses.astuple(q) for q in ported.questions] == \
        [dataclasses.astuple(q) for q in data.questions]
    index, tindex = setup["index"], setup["tindex"]
    np.testing.assert_array_equal(tindex.tf, index.tf)
    np.testing.assert_array_equal(tindex.idf, index.idf)
    texts = [q.text for q in data.questions[:8]]
    qvs = np.stack([index.query_vector(t) for t in texts])
    np.testing.assert_allclose(
        tindex.scores_batch(torch.from_numpy(qvs)).numpy(),
        np.asarray(index.scores_batch(jnp.asarray(qvs))), rtol=1e-5,
        atol=1e-5)
    for t in texts:
        for k in (2, 5, 10):
            assert tindex.passages(t, k) == \
                IndexRetriever("bm25", index).passages(t, k)
        np.testing.assert_array_equal(tindex.score_stats(t),
                                      index.score_stats(t))


def _serve(gateway_cls, request_cls, policy, backend, index, router, qs,
           adaptive):
    rows = []
    gw = gateway_cls(policy, backend, router_cfg=router, index=index,
                     max_batch=6, adaptive_refusal=adaptive,
                     on_outcome=lambda r, a, o, rew: rows.append(
                         (r.qid, a.idx, o.answer, o.cost_tokens, o.refused,
                          o.hallucinated, o.hit, rew)))
    reqs = [request_cls(qid=q.qid, question=q,
                        slo="cheap" if i % 3 == 2 else "quality_first")
            for i, q in enumerate(qs)]
    st = gw.serve(reqs)
    return rows, st, [d.actions.tolist() for d in st.decisions]


def _assert_same(setup, ref_policy, port_policy, adaptive):
    qs_ref = setup["data"].questions[-12:]
    qs_port = setup["ported"].questions[-12:]
    want = _serve(RefGateway, RefRequest, ref_policy, setup["ref_backend"],
                  setup["index"], setup["router"], qs_ref, adaptive)
    got = _serve(Gateway, Request, port_policy, setup["port_backend"],
                 setup["tindex"], RouterConfig(**dataclasses.asdict(
                     setup["router"])), qs_port, adaptive)
    (rrows, rst, racts), (trows, tst, tacts) = want, got
    assert tacts == racts
    assert trows == rrows
    assert dict(tst.action_counts) == dict(rst.action_counts)
    assert tst.avg_reward == rst.avg_reward
    for f in ("served", "rejected", "refusal_cap_history", "total_reward"):
        assert getattr(tst, f) == getattr(rst, f), f
    return tst


def test_fixed_baseline_serves_identically(setup):
    st = _assert_same(setup, RefFixed(0), FixedPolicy(0), adaptive=False)
    assert dict(st.action_counts) == {0: 12}


def test_trained_mlp_policy_serves_identically(setup):
    tr = setup["trained"]
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, tr.params),
                               device="cpu")
    router = RouterConfig(**dataclasses.asdict(setup["router"]))
    st = _assert_same(setup, RefMLP(tr.params, setup["router"]),
                      MLPPolicy(params, router), adaptive=True)
    assert st.served == 12
    assert len(st.action_counts) > 1       # a routed mix, not one bucket
