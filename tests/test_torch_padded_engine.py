"""The port's padded-bucket ``Engine`` and ``EngineBackend.execute_batch``
against the reference, on qwen SMOKE float32 with the reference's params
bridged.

``Engine.generate``: greedy tokens and step counts identical to the
reference's ``Engine`` (equal-length and right-padded buckets), and,
trimmed at EOS, to the port's ``ContinuousEngine`` on the same prompts
(``tests/test_continuous_engine.py``'s parity); first-token logits within
1e-4; its EOS stopping rule on a stub model (``tests/test_serving_layer.py``);
the cache allocated per call on the params' device.  Then
``Gateway.serve`` over ``EngineBackend`` (the bucketed ``execute_batch``
path): outcomes, rewards and ``GatewayStats`` identical.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.config import RetrievalConfig as RefRetrievalConfig
from repro.data.synthetic_squad import SyntheticSquad as RefSquad
from repro.data.tokenizer import HashTokenizer as RefTokenizer
from repro.models import build_model as ref_build
from repro.retrieval.bm25 import BM25Index as RefBM25
from repro.routing import EngineBackend as RefEngineBackend
from repro.routing import FixedPolicy as RefFixed
from repro.routing import Gateway as RefGateway
from repro.routing import Request as RefRequest
from repro.serving.engine import Engine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import RetrievalConfig
from repro_torch.data import HashTokenizer, SyntheticSquad
from repro_torch.data.tokenizer import EOS, trim_at_eos
from repro_torch.models import build_model
from repro_torch.retrieval import BM25Index
from repro_torch.routing import (EngineBackend, FixedPolicy, Gateway,
                                 Request)
from repro_torch.serving import ContinuousEngine, Engine, GenerationResult

ZERO_STATE = lambda qs: np.zeros((len(qs), 1))


@pytest.fixture(scope="module")
def models():
    rc = dataclasses.replace(ref_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    tc = dataclasses.replace(get_config("qwen1.5-32b", "smoke"),
                             dtype="float32")
    rm, tm = ref_build(rc), build_model(tc)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       rm.init(jax.random.PRNGKey(0)))
    return (rc, rm, jax.tree_util.tree_map(jnp.asarray, np_params),
            tc, tm, params_from_numpy(np_params, device="cpu"))


def _prompts(vocab, n, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(4, vocab, size=lengths[i % len(lengths)]))
            for i in range(n)]


@pytest.mark.parametrize("lengths", [[10], [6, 11, 9]],
                         ids=["equal", "right-padded"])
def test_generate_identical_to_reference(models, lengths):
    rc, rm, rp, tc, tm, tp = models
    prompts = _prompts(tc.vocab_size, 5, lengths)
    want = RefEngine(rm, rp, max_len=64).generate(prompts, max_new_tokens=12)
    got = Engine(tm, tp, max_len=64).generate(prompts, max_new_tokens=12)
    assert isinstance(got, GenerationResult)
    assert got.tokens.dtype == np.int32
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.n_steps == want.n_steps


def test_first_logits_within_tolerance(models):
    """The prefill behind the first token: float32 logits within 1e-4 of
    the reference's on the same right-padded bucket."""
    rc, rm, rp, tc, tm, tp = models
    prompts = _prompts(tc.vocab_size, 3, [6, 11, 9], seed=3)
    toks = np.zeros((3, 11), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    want, _ = rm.prefill(rp, {"tokens": jnp.asarray(toks)},
                         rm.init_cache(3, 20))
    got, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        tm.init_cache(3, 20, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("prefill_batch", [1, 3])
def test_greedy_parity_with_continuous_engine(models, prefill_batch):
    """Per request, trimmed at its EOS, the padded engine's greedy tokens
    equal the continuous engine's on equal-length prompts, with more
    prompts than slots."""
    *_, tc, tm, tp = models
    prompts = _prompts(tc.vocab_size, 5, [10])
    res = Engine(tm, tp, max_len=64).generate(prompts, max_new_tokens=12)
    ce = ContinuousEngine(tm, tp, num_slots=3, max_len=64, max_new_cap=16,
                          sync_every=4, prefill_batch=prefill_batch)
    outs = ce.generate_many(prompts, max_new_tokens=12)
    for i in range(len(prompts)):
        assert trim_at_eos(res.tokens[i]) == trim_at_eos(outs[i].tokens), i
    assert ce.stats.max_concurrent == 3 and ce.stats.n_admitted == 5


class _ConstModel:
    """Stub model emitting a constant next token (prefill vs decode);
    records the device of every cache it is asked for."""

    def __init__(self, prefill_tok, decode_tok, vocab=16):
        self.prefill_tok, self.decode_tok, self.vocab = \
            prefill_tok, decode_tok, vocab
        self.cache_devices = []

    def init_cache(self, B, L, *, device):
        self.cache_devices.append(torch.device(device))
        return {"pos": torch.zeros(B, dtype=torch.int32, device=device)}

    def _logits(self, tokens, tok):
        B, T = tokens.shape
        return torch.nn.functional.one_hot(
            torch.full((B, T), tok), self.vocab).float()

    def prefill(self, params, batch, cache, *, mla_absorb=False):
        return self._logits(batch["tokens"], self.prefill_tok), cache

    def decode(self, params, batch, cache, *, mla_absorb=False):
        return self._logits(batch["tokens"], self.decode_tok), cache


STUB_PARAMS = {"embed": torch.zeros(1)}


def test_engine_stops_once_every_sequence_emitted_eos():
    eng = Engine(_ConstModel(prefill_tok=EOS, decode_tok=5), STUB_PARAMS)
    res = eng.generate([[4, 5], [6]], max_new_tokens=6)
    assert res.n_steps == 1
    assert res.tokens.shape == (2, 1)
    assert (res.tokens[:, 0] == EOS).all()


def test_engine_runs_full_length_without_eos():
    model = _ConstModel(prefill_tok=7, decode_tok=5)
    eng = Engine(model, STUB_PARAMS)
    res = eng.generate([[4, 5], [6]], max_new_tokens=6)
    assert res.n_steps == 6
    assert res.tokens.shape == (2, 6)
    assert res.tokens[:, 1:].tolist() == [[5] * 5] * 2
    # one cache a call, on the params' device
    eng.generate([[4]], max_new_tokens=2)
    assert model.cache_devices == [torch.device("cpu")] * 2


def test_engine_needs_params_on_a_device():
    with pytest.raises(ValueError, match="params"):
        Engine(_ConstModel(7, 5), {})


class _Cycle:
    """A policy cycling through fixed actions, built on one package's
    ``FixedPolicy`` (several action buckets a micro-batch)."""

    def __init__(self, fixed_cls, actions):
        self.inner = fixed_cls(actions[0])
        self.name = "cycle"
        self.actions = np.asarray(actions, np.int64)

    def route(self, states, slo=None, context=None):
        d = self.inner.route(states, slo, context)
        d.actions = np.resize(self.actions, len(states))
        return d


@pytest.mark.parametrize("actions", [[0], [0, 2, 4, 1]],
                         ids=["fixed-a0", "mixed-buckets"])
def test_gateway_execute_batch_identical(models, actions):
    """``Gateway.serve`` over ``EngineBackend``: each routed action bucket
    runs as one padded ``Engine.generate`` call; outcomes, rewards and
    stats are the reference's."""
    rc, rm, rp, tc, tm, tp = models
    ref_data = RefSquad(n_paragraphs=40, n_questions=12, seed=0)
    data = SyntheticSquad(n_paragraphs=40, n_questions=12, seed=0)
    texts = [p.text for p in data.paragraphs]
    ref_index = RefBM25.build(texts, RefRetrievalConfig(vocab_hash_dim=1024))
    index = BM25Index.build(texts, RetrievalConfig(vocab_hash_dim=1024))
    kw = dict(max_prompt_len=48, max_new_tokens=4)

    def serve(gw_cls, fixed_cls, req_cls, engine, backend_cls, tok, idx,
              qs):
        outs = []
        gw = gw_cls(_Cycle(fixed_cls, actions),
                    backend_cls(engine, tok, idx, **kw),
                    state_fn=ZERO_STATE, max_batch=8,
                    adaptive_refusal=False,
                    on_outcome=lambda r, a, o, rew: outs.append(
                        (r.qid, a.idx, o.answer, o.refused, o.cost_tokens,
                         o.hit, o.hallucinated, rew)))
        st = gw.serve([req_cls(qid=q.qid, question=q, slo="quality_first")
                       for q in qs])
        return outs, (st.served, dict(sorted(st.action_counts.items())),
                      st.total_reward, st.rejected, st.degraded)

    want = serve(RefGateway, RefFixed, RefRequest, RefEngine(rm, rp),
                 RefEngineBackend, RefTokenizer(rc.vocab_size), ref_index,
                 ref_data.questions)
    got = serve(Gateway, FixedPolicy, Request, Engine(tm, tp),
                EngineBackend, HashTokenizer(tc.vocab_size), index,
                data.questions)
    assert got == want
    assert got[1][0] == 12
    if len(actions) > 1:
        assert len(got[1][1]) == 4
