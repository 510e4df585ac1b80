"""The port's dry run (``repro_torch.launch.dryrun``).

* **The arguments.**  For every arch x input shape ``shape_supported``
  allows x both production layouts, the bytes of rank 0's arguments
  (``argument_size_in_bytes``) equal the sum of the reference's shard
  shapes (``NamedSharding.shard_shape``) x itemsize of its
  ``param_specs`` / ``opt_specs`` / ``batch_specs`` for a train step,
  and of its ``batch_specs`` / ``cache_specs`` with the weights'
  shardings at ``fsdp=False`` for prefill and decode.  The one
  difference is named: the port serves with the weights whole over
  ``data`` (``ShardedExecutor``'s placement; its prefill and decode have
  no FSDP gather), where the reference's dry run hands its serve steps
  the FSDP specs for GSPMD to gather.  The reference runs in a
  subprocess on a forced 512-device host platform with a HOME of its
  own, as ``tests/test_torch_specs.py`` runs it.
* **The trace against a real step.**  qwen SMOKE (float32) traced as
  rank 0 of a fake world gives the same collective counts and bytes,
  FLOPs, bytes accessed, peak of live bytes, argument and output bytes
  as the same step run for real on rank 0 of a gloo world of that size
  (``tests/torch_dist_training.py``'s worker bodies, zero weights and
  batch): train at dp = 2, mp = 2, dp = 2 x mp = 2 and pod = 2 x dp = 2,
  decode at mp = 2.  One difference is named, and held exactly: gloo's
  reduce-scatter copies its result into the output (``aten.copy_``),
  which adds twice the reduce-scatter's bytes to the real run's bytes
  accessed (under 1 % here).
* **K1 on fake CUDA tensors**: the output's shape and dtype, one
  would-be launch a call in the census (the wrapper's own count, of
  real launches, unmoved), and ``FlopCounterMode``'s count equal to the plain version's
  at the same shapes.  A whole SMOKE decode on fake CUDA tensors needs a
  torch built with CUDA (a CPU-only build has no CUDA device guard to
  index them with): that case runs only there, and ``chip_smoke.py``'s
  dry-run phase holds qwen FULL's 64 launches on the card.
* **The CLI**: a refused combination (whisper-large-v3 with
  ``cross/wk`` taken out of ``TP_AXES`` in the subprocess) prints
  ``FAIL`` with ``check_tensor_parallel``'s message and exits 1; an
  accepted one writes its record; qwen1.5-32b's decode_32k passes as
  published on the head_dim route, its census and scores' bytes as the
  route sends them, no would-be K1 launch; mamba2-130m's decode_32k
  passes on the Mamba2 route, two all-reduces a layer; whisper-large-v3's
  decode_32k passes as published, its cross-attention's summed scores
  and output all-reduced a decoder layer.  Each runs in a subprocess (a
  process makes one world).
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_training as W
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_supported)
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from torch_dist import run_world

ROOT = Path(__file__).resolve().parents[1]
QWEN = "qwen1.5-32b"

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import numpy as np
import jax
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config, shape_supported
from repro.launch.mesh import make_production_mesh
from repro.launch import specs as S
from repro.models.schema import schema_shapes
from repro.models.transformer import decoder_param_schema
from repro.sharding import shardings_for_schema


def nbytes(tree, shardings=None):
    total = 0
    if shardings is None:
        leaves = [(s, s.sharding) for s in jax.tree_util.tree_leaves(tree)]
    else:
        leaves = list(zip(jax.tree_util.tree_leaves(tree),
                          jax.tree_util.tree_leaves(shardings)))
    for s, sh in leaves:
        total += int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
    return total


res = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        ep = S.use_ep(cfg, mesh)
        schema = decoder_param_schema(cfg)
        train_w = nbytes(S.param_specs(cfg, mesh, ep=ep)) + nbytes(
            S.opt_specs(cfg, mesh, ep=ep))
        serve_w = nbytes(schema_shapes(schema), shardings_for_schema(
            schema, mesh, fsdp=False, ep=ep))
        for shape in INPUT_SHAPES:
            if not shape_supported(arch, shape):
                continue
            b = nbytes(S.batch_specs(cfg, shape, mesh))
            if INPUT_SHAPES[shape]["kind"] == "train":
                total = train_w + b
            else:
                total = serve_w + b + nbytes(S.cache_specs(cfg, shape, mesh))
            res[f"{int(multi)}|{arch}|{shape}"] = total
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref_bytes(tmp_path_factory):
    r = subprocess.run(
        [sys.executable, "-c", REF],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path_factory.mktemp("dryrun_home")),
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("multi_pod", (False, True), ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference_shards(ref_bytes, arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch, "full")
    shapes = [s for s in INPUT_SHAPES if shape_supported(arch, s)]
    assert shapes
    for shape in shapes:
        got = D.argument_bytes(D.step_specs(cfg, INPUT_SHAPES[shape], mesh))
        assert got == ref_bytes[f"{int(multi_pod)}|{arch}|{shape}"], shape


# ---------------------------------------------------------------------------
# The trace against a real gloo world
# ---------------------------------------------------------------------------

TRAIN = dict(kind="train", global_batch=8, seq_len=64)
DECODE = dict(kind="decode", global_batch=4, seq_len=64)
# (id, mesh spec of the real world, layout axes, grid, shape)
WORLDS = [
    ("train-dp2", "dp=2", ("data", "model"), (2, 1), TRAIN),
    ("train-mp2", "dp=1,mp=2", ("data", "model"), (1, 2), TRAIN),
    ("train-dp2xmp2", "dp=2,mp=2", ("data", "model"), (2, 2), TRAIN),
    ("train-pod2xdp2", "pod=2,dp=2", ("pod", "data", "model"), (2, 2, 1),
     TRAIN),
    ("decode-mp2", "dp=1,mp=2", ("data", "model"), (1, 2), DECODE),
]
COUNTED = ("flops", "bytes_accessed", "collective_bytes", "collective_counts",
           "argument_size_in_bytes", "output_size_in_bytes",
           "temp_size_in_bytes", "peak_bytes", "launches", "info")


def _fake_all(rank, cases):
    return [W.dryrun_fake(rank, axes, grid, QWEN, {}, shape)
            for axes, grid, shape in cases]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_worlds")
    fake = run_world(_fake_all, 1, tmp,
                     [(axes, grid, shape) for _, _, axes, grid, shape
                      in WORLDS])[0]
    real = {}
    for (key, spec, _, grid, shape), rec in zip(WORLDS, fake):
        real[key] = run_world(W.dryrun_real, int(np.prod(grid)), tmp, spec,
                              QWEN, {}, shape)[0], rec
    return real


@pytest.mark.parametrize("key", [w[0] for w in WORLDS])
def test_trace_on_a_fake_world_equals_the_real_step(traced, key):
    real, fake = traced[key]
    for field in COUNTED:
        if field == "bytes_accessed" and key.startswith("train"):
            # gloo's reduce-scatter writes its result into the output
            # with an aten.copy_ on the calling thread as the work
            # completes (the source read, the output written); NCCL
            # and the fake backend write the output in place
            extra = 2 * real["collective_bytes"]["reduce-scatter"]
            assert real[field] - fake[field] == extra, (key, real[field],
                                                        fake[field], extra)
            assert extra <= 0.01 * fake[field]
            continue
        assert fake[field] == real[field], (key, field, fake[field],
                                            real[field])
    assert fake["flops"] > 0 and fake["temp_size_in_bytes"] > 0
    counts = fake["collective_counts"]
    if key.startswith("train"):
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    else:
        # the embedding's all-reduce and two a layer; the logits' gather
        n_layers = get_config(QWEN, "smoke").n_layers
        assert counts["all-reduce"] == 2 * n_layers + 1
        assert counts["all-gather"] == 1


def test_pod_adds_one_all_reduce_and_halves_the_rows(traced):
    """pod = 2 x dp = 2 against dp = 2: rank 0 holds half the rows (the
    FLOPs halve) and the same weight shards; the step adds the
    all-reduce of the FSDP shards' gradients over pod."""
    one, _ = traced["train-dp2"]
    two, _ = traced["train-pod2xdp2"]
    assert two["flops"] * 2 == pytest.approx(one["flops"], rel=0.05)
    assert (two["collective_counts"]["all-reduce"]
            == one["collective_counts"]["all-reduce"] + 1)
    assert (two["collective_counts"]["all-gather"]
            == one["collective_counts"]["all-gather"])


def test_pick_microbatches_bounds_the_carry():
    cfg = get_config(QWEN, "full")
    assert D.pick_microbatches(cfg, 256, 4096, 16) == 16
    assert D.pick_microbatches(cfg, 256, 4096, 32) == 8
    assert D.pick_microbatches(get_config("mamba2-130m", "full"),
                               256, 4096, 16) == 8


# ---------------------------------------------------------------------------
# K1's fake rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,L,D", [(8, 40, 8, 392, 128),
                                         (2, 16, 16, 64, 256),
                                         (3, 32, 4, 100, 96)])
def test_flash_decode_fake_rule(B, H, Hkv, L, D):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_decode import (decode_flops, flash_decode,
                                                  flash_decode_torch)
    from repro_torch.launch.dryrun import Census
    counted = {}
    for dev in ("cuda", "cpu"):
        with FakeTensorMode():
            q = torch.empty(B, H, D, dtype=torch.bfloat16, device=dev)
            k = torch.empty(B, L, Hkv, D, dtype=torch.bfloat16, device=dev)
            v = torch.empty_like(k)
            lengths = torch.empty(B, dtype=torch.int32, device=dev)
            before = flash_decode.launches
            census = Census()
            with FlopCounterMode(display=False) as fc, census:
                out = flash_decode(q, k, v, lengths)
            assert out.shape == (B, H, D) and out.dtype == torch.bfloat16
            assert out.device.type == dev
            # nothing launched: the wrapper's count is of real launches
            assert flash_decode.launches == before
            counted[dev] = (fc.get_total_flops(),
                            census.launches["flash_decode"])
            if dev == "cpu":
                with FlopCounterMode(display=False) as fc:
                    flash_decode_torch(q, k, v, lengths)
                counted["cpu-plain"] = fc.get_total_flops()
    assert counted["cuda"] == (counted["cpu-plain"], 1)
    assert counted["cpu"] == (counted["cpu-plain"], 0)
    assert counted["cpu-plain"] == decode_flops(B, H, L, D, D)


def test_smoke_decode_on_fake_cuda_tensors_counts_k1_once_a_layer():
    if not torch.version.cuda:
        pytest.skip("a CPU-only torch has no CUDA device guard, so it "
                    "cannot index a fake CUDA tensor (the card's run: "
                    "chip_smoke.py's dry-run phase)")
    from repro_torch.launch.mesh import LayoutMesh
    cfg = get_config(QWEN, "smoke")
    layout = LayoutMesh(("data", "model"), np.arange(1).reshape(1, 1))
    code = ("import json, numpy as np\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.launch import dryrun as D\n"
            "from repro_torch.launch.mesh import LayoutMesh\n"
            "lay = LayoutMesh(('data', 'model'), np.arange(1).reshape(1, 1))\n"
            "shape = dict(kind='decode', global_batch=4, seq_len=64)\n"
            "cfg = get_config('qwen1.5-32b', 'smoke')\n"
            "r = {d: D.trace_case(cfg, shape, lay, device=d)\n"
            "     for d in ('cuda', 'cpu')}\n"
            "print(json.dumps(r))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin",
                            "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    recs = json.loads(r.stdout.splitlines()[-1])
    assert layout.devices.size == 1
    assert recs["cuda"]["launches"]["flash_decode"] == cfg.n_layers
    assert recs["cpu"]["launches"]["flash_decode"] == 0
    assert recs["cuda"]["flops"] == recs["cpu"]["flops"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli(tmp_path, *argv, before=""):
    code = ("import sys\nfrom pathlib import Path\n"
            "from repro_torch.launch import dryrun as D\n"
            f"D.RESULTS_DIR = Path({str(tmp_path)!r})\n{before}"
            f"sys.exit(D.main({list(argv)!r}))\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})


def test_cli_prints_fail_for_a_refused_combination(tmp_path):
    """Every published family passes; with ``cross/wk``'s entry taken
    out of ``TP_AXES`` whisper's cross layers have no route, and the CLI
    prints the check's message as a FAIL line and exits 1."""
    arch = "whisper-large-v3"
    r = _cli(tmp_path, "--arch", arch, "--shape", "decode_32k",
             "--device", "cpu",
             before="from repro_torch.models import transformer as T\n"
                    "del T.TP_AXES['cross/wk']\n")
    assert r.returncode == 1, r.stderr[-3000:]
    fail = [ln for ln in r.stdout.splitlines() if ln.startswith("FAIL")]
    assert len(fail) == 1 and f"{arch}__decode_32k__single" in fail[0]
    assert "tensor parallelism at mp=16 has no collective" in fail[0]
    assert "blocks/p0/cross/wk (32, 1280, 20, 64)" in fail[0]
    assert "ROADMAP.md queue 3" in fail[0]
    assert not list(tmp_path.glob("*.json"))


def test_cli_passes_whisper_decode_with_the_cross_census(tmp_path):
    """whisper-large-v3 as published (20 heads and kv heads: head_dim on
    the 16-way model axis, its cross layers and cross cache too) at
    decode_32k on the single-pod layout: the census (the embedding's
    all-reduce and five a decoder layer: the self-attention's summed
    scores and output, the cross-attention's summed scores over the 1500
    encoder rows and output, the MLP's output; one all-gather a layer of
    the step's q / k / v rows, and the logits'; no all-to-all), the
    scores' bytes, and no would-be K1 launch."""
    arch = "whisper-large-v3"
    r = _cli(tmp_path, "--arch", arch, "--shape", "decode_32k",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert f"OK    {arch}__decode_32k__single" in r.stdout
    rec = json.loads((tmp_path / f"{arch}__decode_32k__single.json")
                     .read_text())
    cfg = get_config(arch, "full")
    n, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    B = INPUT_SHAPES["decode_32k"]["global_batch"] // 16
    L = INPUT_SHAPES["decode_32k"]["seq_len"]
    assert rec["collective_counts"] == {
        "all-gather": n + 1, "all-reduce": 5 * n + 1, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    cross = B * H * cfg.encoder_seq_len * 4
    assert cross == 960_000          # 0.96 MB a layer
    hidden = B * cfg.d_model * 2
    assert rec["collective_bytes"]["all-reduce"] == (
        n * (B * H * L * 4 + cross + 3 * hidden) + hidden)
    assert rec["collective_bytes"]["all-gather"] == (
        n * B * 3 * H * Dh * 2 + B * cfg.padded_vocab * 4)
    assert rec["launches"]["flash_decode"] == 0
    assert rec["fallbacks"] == []


def test_cli_passes_qwen_decode_unpadded_on_the_head_dim_route(tmp_path):
    """qwen1.5-32b as published (40 heads and kv heads: head_dim on the
    16-way model axis) at decode_32k on the single-pod layout: the
    record, its census (the embedding's all-reduce, three a layer: the
    summed partial scores, the attention's and the MLP's output; one
    all-gather a layer of the step's q / k / v rows, and the logits'),
    the scores' bytes, and no would-be K1 launch."""
    r = _cli(tmp_path, "--arch", QWEN, "--shape", "decode_32k",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads((tmp_path / f"{QWEN}__decode_32k__single.json")
                     .read_text())
    cfg = get_config(QWEN, "full")
    n = cfg.n_layers
    assert rec["collective_counts"]["all-reduce"] == 3 * n + 1
    assert rec["collective_counts"]["all-gather"] == n + 1
    assert rec["collective_counts"]["all-to-all"] == 0
    B = INPUT_SHAPES["decode_32k"]["global_batch"] // 16
    L = INPUT_SHAPES["decode_32k"]["seq_len"]
    scores = B * cfg.n_heads * L * 4
    hidden = B * cfg.d_model * 2
    assert rec["collective_bytes"]["all-reduce"] == (
        n * (scores + 2 * hidden) + hidden)
    assert rec["launches"]["flash_decode"] == 0
    assert rec["fallbacks"] == []
    assert rec["peak_bytes"] < 80e9


def test_cli_passes_mamba2_decode_on_the_ssm_route(tmp_path):
    """mamba2-130m as published (d_inner 1536: 96 columns a rank over the
    16-way model axis, 1.5 heads) at decode_32k on the single-pod
    layout: the census (the embedding's all-reduce and two a Mamba2
    layer, the gated norm's sum of squares and ``w_out``'s output; the
    logits' all-gather) and their bytes (4 float32 bytes and one bf16
    ``d_model`` row a token a layer)."""
    arch = "mamba2-130m"
    r = _cli(tmp_path, "--arch", arch, "--shape", "decode_32k",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert f"OK    {arch}__decode_32k__single" in r.stdout
    rec = json.loads((tmp_path / f"{arch}__decode_32k__single.json")
                     .read_text())
    cfg = get_config(arch, "full")
    n = cfg.n_layers
    B = INPUT_SHAPES["decode_32k"]["global_batch"] // 16
    hidden = B * cfg.d_model * 2
    assert rec["collective_counts"] == {
        "all-gather": 1, "all-reduce": 2 * n + 1, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0}
    assert rec["collective_bytes"]["all-reduce"] == (
        n * (B * 4 + hidden) + hidden)
    assert rec["collective_bytes"]["all-gather"] == (
        B * cfg.padded_vocab * 4)
    assert rec["launches"]["ssd_chunk_scan"] == 0
    assert rec["fallbacks"] == []


@pytest.mark.parametrize("absorb", [False, True],
                         ids=["naive", "absorbed"])
def test_cli_passes_minicpm3_decode_on_the_mla_route(tmp_path, absorb):
    """minicpm3-4b as published (40 heads: its up-projections on
    head_dim over the 16-way model axis, the cached latent on kv_lora)
    at decode_32k on the single-pod layout, naive and absorbed: the
    census (the embedding's all-reduce and two a layer, the attention's
    and the MLP's output; four all-gathers a layer, ``wq_b``, ``wk_b``,
    ``wv_b`` and the cache's ``c_kv``, and the logits'; one all-to-all
    a layer returning each head's columns) and the bytes: the latent's
    128 MiB a layer as ``models/layers.py::_mla_split`` counts them,
    the up-projections', the all-to-all's."""
    argv = ["--arch", "minicpm3-4b", "--shape", "decode_32k", "--device",
            "cpu"] + (["--mla-absorb"] if absorb else [])
    r = _cli(tmp_path, *argv)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads((tmp_path / "minicpm3-4b__decode_32k__single.json")
                     .read_text())
    cfg = get_config("minicpm3-4b", "full")
    m, n = cfg.mla, cfg.n_layers
    assert rec["collective_counts"]["all-reduce"] == 2 * n + 1
    assert rec["collective_counts"]["all-gather"] == 4 * n + 1
    assert rec["collective_counts"]["all-to-all"] == n
    B = INPUT_SHAPES["decode_32k"]["global_batch"] // 16
    L = INPUT_SHAPES["decode_32k"]["seq_len"]
    latent = B * L * m.kv_lora_rank * 2
    assert latent == 128 * 2**20
    weights = 2 * cfg.n_heads * (
        m.q_lora_rank * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        + m.kv_lora_rank * (m.qk_nope_head_dim + m.v_head_dim))
    logits = B * cfg.padded_vocab * 4
    assert rec["collective_bytes"]["all-gather"] == (
        n * (latent + weights) + logits)
    assert rec["collective_bytes"]["all-reduce"] == (
        (2 * n + 1) * B * cfg.d_model * 2)
    # each head's 4 of 64 value columns to wo's rank, in bf16 on both
    # routes (the absorbed one's float32 output cast first)
    assert rec["collective_bytes"]["all-to-all"] == (
        n * B * cfg.n_heads * (m.v_head_dim // 16) * 2)
    assert rec["info"].get("mla_absorb", False) == absorb
    assert rec["fallbacks"] == []


def test_cli_writes_the_record_of_an_accepted_combination(tmp_path):
    arch = "phi-3-vision-4.2b"
    r = _cli(tmp_path, "--arch", arch, "--shape", "decode_32k", "--mesh",
             "multi", "--device", "cpu", "--tag", "_t")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "ALL DRY-RUNS PASSED" in r.stdout
    # the route is on the header and on the OK line
    assert r.stdout.splitlines()[0] == "device cpu: the plain route"
    ok = [ln for ln in r.stdout.splitlines() if ln.startswith("OK")]
    assert len(ok) == 1 and " device=cpu " in ok[0]
    rec = json.loads((tmp_path / f"{arch}__decode_32k__multi_t.json")
                     .read_text())
    assert rec["n_devices"] == 512 and rec["mesh"] == "multi"
    mesh = make_production_mesh(multi_pod=True)
    assert rec["argument_size_in_bytes"] == D.argument_bytes(D.step_specs(
        get_config(arch, "full"), INPUT_SHAPES["decode_32k"], mesh))
    assert rec["peak_bytes"] == (rec["argument_size_in_bytes"]
                                 + rec["temp_size_in_bytes"])
    # the embedding's all-reduce and two a layer, the logits' gather
    n_layers = get_config(arch, "full").n_layers
    assert rec["collective_counts"]["all-reduce"] == 2 * n_layers + 1
    assert rec["collective_counts"]["all-gather"] == 1
    assert rec["flops"] > 0 and rec["fallbacks"] == []


def test_pad_heads_pads_to_the_multiple():
    cfg = D.configure(QWEN, pad_heads=16)
    assert (cfg.n_heads, cfg.n_kv_heads) == (48, 48)
    cfg = D.configure("command-r-35b", pad_heads=16)
    assert (cfg.n_heads, cfg.n_kv_heads) == (64, 16)
    assert D.configure(QWEN) == get_config(QWEN, "full")
