"""Package rules of the port: ``repro_torch`` imports neither JAX nor
the JAX package, its entry points run on ``cuda`` unless the caller
asks for the CPU (and raise without a card), its wrappers validate what
they launch, and the kernels agree with their plain versions on the card
(``gpu`` tests: they skip inside the test when no card is present).
"""

import ast
import copy
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.core.baselines import block_dbscan, knn_block_dbscan, rho_approx_dbscan
from repro_torch.core.cardinality.features import build_training_set
from repro_torch.core.dbscan import dbscan_parallel, dbscan_sequential
from repro_torch.core.dbscan_pp import dbscan_pp
from repro_torch.core.laf_dbscan import laf_dbscan, laf_dbscan_sequential
from repro_torch.core.pipeline import LAFPipeline
from repro_torch.core.range_query import range_counts
from repro_torch.core.union_find import label_propagation, label_propagation_dense
from repro_torch.index.exact import ExactBackend
from repro_torch.index.random_projection import RandomProjectionBackend
from repro_torch.index.signatures import make_projection, sign_signatures
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import ctr_batch
from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ops import LAUNCHES as EB_LAUNCHES
from repro_torch.kernels.hamming_filter import hamming_filter_bitmap, hamming_filter_count, hamming_filter_into
from repro_torch.kernels.hamming_filter.ref import hamming_filter_ref
from repro_torch.kernels.label_prop import col_reduce, label_prop_rect, label_prop_update, label_propagation_pallas
from repro_torch.kernels.label_prop.ref import col_reduce_ref, label_prop_rect_ref, label_prop_update_ref
from repro_torch.models import layers, recsys
from repro_torch.models.transformer import TransformerConfig, make_cache, transformer_from_jax, transformer_init
from repro_torch.obs import device as obs_device
from repro_torch.obs import metrics
from repro_torch.stream import ClusterIndex, DurableStream, StreamingLAF

PKG = Path(repro_torch.__file__).resolve().parent


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    checked = {str(f.relative_to(PKG)) for f in files}
    assert {"configs/registry.py", "configs/llama3_8b.py", "models/layers.py", "models/transformer.py",
            "kernels/flash_attention/ops.py", "kernels/flash_attention/ref.py", "models/recsys.py",
            "configs/bst.py", "configs/deepfm.py", "configs/dien.py", "configs/autoint.py",
            "kernels/embedding_bag/ops.py", "kernels/embedding_bag/ref.py", "core/baselines.py",
            "kernels/popcount/ops.py", "kernels/popcount/ref.py", "stream/state.py", "stream/ingest.py",
            "stream/serve.py", "stream/durability.py", "train/checkpoint.py", "train/fault_tolerance.py",
            "testing/faults.py", "configs/laf_dbscan.py"} <= checked
    bad = [
        (f.relative_to(PKG), m) for f in files for m in _imports(f)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []
    root = Path(__file__).resolve().parents[1]
    scripts = [root / "chip_smoke.py", *sorted((root / "examples").glob("*_torch.py"))]
    assert len(scripts) == 5  # quickstart, cluster_embeddings, train_lm, recsys_serving
    assert [(s.name, m) for s in scripts for m in _imports(s) if m.split(".")[0] in ("jax", "repro")] == []


def test_entry_points_default_to_cuda(tmp_path):
    """Without a card every entry point raises unless told device='cpu';
    with one, the default is cuda."""
    x = np.random.default_rng(0).standard_normal((40, 8)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    words, active, adj = np.zeros((40, 2), np.uint32), np.ones(40, bool), np.eye(40, dtype=bool)
    lm = TransformerConfig(vocab=32, d_model=16, n_layers=1, n_heads=2, kv_heads=1, d_head=8, d_ff=32)
    rec = {name: get_arch(name).make_reduced_config() for name in ("bst", "deepfm", "dien", "autoint")}
    rec_inits = [getattr(recsys, f"{name}_init") for name in rec]
    helpers = [
        lambda **kw: layers.dense_init(None, 4, 2, **kw),
        lambda **kw: layers.rmsnorm_init(4, **kw)["scale"],
        lambda **kw: layers.layernorm_init(4, **kw)["bias"],
        lambda **kw: layers.swiglu_init(None, 4, 8, **kw)["wo"],
        lambda **kw: layers.geglu_init(None, 4, 8, **kw)["wi_up"],
        lambda **kw: layers.mlp_init(None, [4, 3, 1], **kw)[1]["b"],
        lambda **kw: layers.rope_frequencies(8, **kw),
        lambda **kw: obs_device.cluster_telemetry_init(4, **kw),
    ]
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert all(h().device.type == "cuda" for h in helpers)
        assert all(next(init(0, cfg).parameters()).device.type == "cuda" for init, cfg in zip(rec_inits, rec.values()))
        with pytest.raises(ValueError, match="generator"):  # a generator must live where the weights go
            layers.dense_init(torch.Generator(), 4, 2)
        with pytest.raises(ValueError, match="generator"):
            recsys.bst_init(torch.Generator(), rec["bst"])
        assert RandomProjectionBackend().device.type == "cuda"
        assert ExactBackend().device.type == "cuda"
        assert transformer_init(0, lm).embed.device.type == "cuda"
        assert make_cache(lm, 1, 4)["k"].device.type == "cuda"
        assert StreamingLAF(0.5, 3).backend.device.type == "cuda"
        assert ClusterIndex(x, np.zeros(40, np.int64), 0.5).device.type == "cuda"
        assert DurableStream(StreamingLAF(0.5, 3), tmp_path, fsync=False).backend.device.type == "cuda"
        return
    calls = [
        resolve_device,
        lambda: LAFPipeline(),
        lambda: RandomProjectionBackend(),
        lambda: sign_signatures(x, make_projection(8, 64)),
        lambda: build_training_set(x, (0.5,)),
        lambda: laf_dbscan(x, 0.5, 3, 1.0, np.full(40, 10.0)),
        lambda: ExactBackend(),
        lambda: range_counts(x, x, 0.5),
        lambda: dbscan_parallel(x, 0.5, 3),
        lambda: dbscan_pp(x, 0.5, 3, 0.5),
        lambda: dbscan_sequential(x, 0.5, 3),
        lambda: laf_dbscan_sequential(x, 0.5, 3, 1.0, lambda i: 10.0),
        lambda: label_propagation(words, active),
        lambda: label_propagation_dense(adj, active),
        lambda: label_propagation_pallas(words, active),
        lambda: transformer_init(0, lm),
        lambda: make_cache(lm, 1, 4),
        lambda: transformer_from_jax({}, lm),
        *helpers,
        *[lambda init=init, cfg=cfg: init(0, cfg) for init, cfg in zip(rec_inits, rec.values())],
        lambda: recsys.recsys_from_jax({}, rec["bst"]),
        lambda: knn_block_dbscan(x, 0.5, 3),
        lambda: block_dbscan(x, 0.5, 3),
        lambda: rho_approx_dbscan(x, 0.5, 3),
        lambda: StreamingLAF(0.5, 3),
        lambda: StreamingLAF(0.5, 3, backend="exact"),
        lambda: ClusterIndex(x, np.zeros(40, np.int64), 0.5),
        lambda: DurableStream(StreamingLAF(0.5, 3), tmp_path / "d"),
        lambda: DurableStream.recover(tmp_path / "r", lambda: StreamingLAF(0.5, 3)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"
    want = torch.arange(40, dtype=torch.int32)
    assert torch.equal(label_propagation(words, active, device="cpu"), want)
    assert torch.equal(label_propagation_dense(adj, active, device="cpu"), want)
    assert torch.equal(label_propagation_pallas(words, active, device="cpu"), want)
    model = transformer_init(0, lm, device="cpu")
    assert model.embed.device.type == "cpu" and make_cache(lm, 1, 4, device="cpu")["v"].device.type == "cpu"
    params = {"embed": model.embed.float().numpy(), "lm_head": model.lm_head.float().numpy(),
              "ln_f": {"scale": np.ones(16, np.float32)},
              "layers": {g: {n: p.float().numpy()[None] for n, p in d.items()} for g, d in model.layers[0].items()}}
    assert torch.equal(transformer_from_jax(params, lm, device="cpu").lm_head, model.lm_head)
    assert all(h(device="cpu").device.type == "cpu" for h in helpers)
    assert all(next(init(0, cfg, device="cpu").parameters()).device.type == "cpu"
               for init, cfg in zip(rec_inits, rec.values()))
    assert StreamingLAF(0.5, 3, device="cpu").partial_fit(x).n_points == 40
    assert DurableStream(StreamingLAF(0.5, 3, device="cpu"), tmp_path / "c", fsync=False).backend.device.type == "cpu"


def test_wrappers_validate_operands():
    q = torch.zeros((4, 8))
    sig = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        hamming_filter_bitmap(q.double(), q, sig, sig, 0.5, 10)
    with pytest.raises(TypeError):
        hamming_filter_bitmap(q, q, sig.long(), sig, 0.5, 10)
    with pytest.raises(ValueError):
        hamming_filter_bitmap(q, q[:, :4], sig, sig, 0.5, 10)
    with pytest.raises(ValueError):
        hamming_filter_bitmap(q, q, sig, torch.zeros((4, 33), dtype=torch.int32), 0.5, 10)
    slab = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        label_prop_rect(torch.zeros(4, dtype=torch.int32), torch.zeros(32, dtype=torch.int32), slab)
    with pytest.raises(ValueError):
        col_reduce(slab.long(), torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))


def test_build_needs_nvcc():
    """Kernels build only where the CUDA toolkit is: here the loader
    says so instead of falling back to anything."""
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert all((_build.CSRC / f"{n}.cu").is_file() for n in _build.SOURCES)
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here; the missing-toolkit error cannot be shown")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("label_prop")


@pytest.fixture
def metrics_on():
    """Counters record only while metrics are on (off by default, as in
    the reference); the switch is process-global, so it is put back."""
    was = metrics.enabled()
    metrics.enable()
    yield metrics
    if not was:
        metrics.disable()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (nq, nd, n_bits, eps, t_lo, t_hi): ragged against the kernel's 128 x 128
# tiles (1, 63, 129 query rows; 1, 31, 257 db rows), 64 to 1024 bits,
# full-verify mode (t_lo = -1) and saturated bands (t_hi >= n_bits,
# eps > 1: every pair is a band pair)
GPU_HAMMING_CASES = [
    (70, 301, 128, 0.5, -1, 70), (33, 1000, 128, 0.45, 40, 70), (5, 40, 128, 1.2, 20, 70),
    (1, 1, 64, 0.5, -1, 40), (63, 31, 512, 0.5, 200, 260), (129, 257, 1024, 0.5, 420, 540),
    (129, 31, 64, 0.5, -1, 64), (63, 257, 512, 1.2, 100, 512), (1, 257, 1024, 0.5, -1, 1024),
]


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nd,n_bits,eps,t_lo,t_hi", GPU_HAMMING_CASES)
def test_gpu_hamming_filter_matches_plain(nq, nd, n_bits, eps, t_lo, t_hi, metrics_on):
    """Every body (count, bitmap, and both with stats at chunk_rows 128
    and >= nq) against the plain version: bits may differ only at the fp32
    boundary, counts by those bits, triples not at all."""
    dev = _card()
    rng = np.random.default_rng(nq + nd + n_bits)
    x = rng.standard_normal((nq + nd, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    sig = sign_signatures(x, make_projection(32, n_bits, 0), device=dev)
    q, db = torch.from_numpy(x[:nq]).to(dev), torch.from_numpy(x[nq:]).to(dev)
    qs, dbs = sig[:nq].contiguous(), sig[nq:].contiguous()
    launches = metrics.counter("kernel.hamming_filter.launches")
    before = launches.value
    kc, kb = hamming_filter_bitmap(q, db, qs, dbs, eps, t_hi, t_lo=t_lo)
    torch.cuda.synchronize()
    assert launches.value == before + 1
    pc, pb = hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi)
    diff = (kb ^ pb).cpu().numpy().view(np.uint32)
    flips = np.unpackbits(diff.view(np.uint8), bitorder="little").reshape(nq, -1)[:, :nd]
    pi, pj = np.nonzero(flips)
    dots = (x[:nq][pi].astype(np.float64) * x[nq:][pj].astype(np.float64)).sum(1)
    assert (np.abs(dots - (1 - eps)) <= 2 * 31 * 2.0 ** -24).all()
    flips_per_row = torch.from_numpy(flips.sum(1).astype(np.int32)).to(dev)
    assert ((kc - pc).abs() <= flips_per_row).all()
    if not len(pi):
        assert torch.equal(kc, pc) and torch.equal(kb, pb)
    assert torch.equal(hamming_filter_count(q, db, qs, dbs, eps, t_hi, t_lo=t_lo), kc)
    for chunk in (128, max(nq, 129)):
        plain = hamming_filter_ref(q, db, qs, dbs, eps, t_lo, t_hi, stats_chunk=chunk)[2]
        for bitmap in (False, True):
            counts = torch.zeros(nq, dtype=torch.int32, device=dev)
            words = torch.zeros_like(kb) if bitmap else None
            stats = torch.zeros((-(-nq // chunk), 3), dtype=torch.int32, device=dev)
            hamming_filter_into(q, db, qs, dbs, eps, t_lo, t_hi, counts, words, stats=stats, chunk_rows=chunk)
            torch.cuda.synchronize()
            assert torch.equal(stats, plain) and torch.equal(counts, kc)
            if bitmap:
                assert torch.equal(words, kb)


def _clustered_slab(r, w, g, density=0.01, clusters=10):
    """An (r, w) int32 slab ~``density`` dense whose bits cluster: row i
    sets bits only in the column span of its cluster, as a row of the
    sweep's slab sets them near its own points."""
    ncol = w * 32
    span = -(-ncol // clusters)
    lo = torch.randint(0, clusters, (r, 1), generator=g) * span
    cols = torch.arange(ncol)[None, :]
    inside = (cols >= lo) & (cols < lo + span)
    bits = inside & (torch.rand(r, ncol, generator=g) < density * ncol / span)
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64)
    words = (bits.view(r, w, 32).to(torch.int64) * weights).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


# fill: "random" dense words; "zeros"; "ones"; "clustered" ~1% dense;
# "extremes" clustered with INT32_MAX on most labels and values.  Shapes
# reach the kernels' edges: W % 4 != 0 (7, 13, 1: 4-byte loads), W = 2048
# (labels of 256 KB, past shared memory: K2 gathers from global memory),
# R past and not a multiple of a block's row chunk (4133).
@pytest.mark.gpu
@pytest.mark.parametrize("r,w,fill", [
    (300, 7, "random"), (64, 40, "random"), (1, 1, "random"), (96, 952, "zeros"), (96, 952, "ones"),
    (1000, 952, "clustered"), (77, 13, "clustered"), (37, 2048, "clustered"), (4133, 64, "clustered"),
    (130, 952, "extremes"),
])
def test_gpu_label_prop_kernels_match_plain(r, w, fill):
    dev = _card()
    g = torch.Generator().manual_seed(r * w)
    if fill == "random":
        bitmap = torch.randint(-2**31, 2**31 - 1, (r, w), generator=g, dtype=torch.int32)
    elif fill in ("zeros", "ones"):
        bitmap = torch.full((r, w), 0 if fill == "zeros" else -1, dtype=torch.int32)
    else:
        bitmap = _clustered_slab(r, w, g)
    bitmap = bitmap.to(dev)
    col = torch.randint(0, 10**6, (w * 32,), generator=g, dtype=torch.int32)
    row = torch.randint(0, 10**6, (r,), generator=g, dtype=torch.int32)
    if fill == "extremes":
        big = torch.iinfo(torch.int32).max
        col = torch.where(torch.rand(w * 32, generator=g) < 0.9, big, col)
        row = torch.where(torch.rand(r, generator=g) < 0.7, big, row)
    col, row = col.to(dev), row.to(dev)
    want = label_prop_rect_ref(row, col, bitmap)
    assert torch.equal(label_prop_rect(row, col, bitmap), want)
    kept = torch.full((r,), -5, dtype=torch.int32, device=dev)
    label_prop_rect(row, col, bitmap, out=kept, flag=torch.zeros(1, dtype=torch.int32, device=dev))
    assert bool((kept == -5).all())  # flag 0: out untouched
    label_prop_rect(row, col, bitmap, out=kept, flag=torch.ones(1, dtype=torch.int32, device=dev))
    assert torch.equal(kept, want)
    weights = torch.randint(0, 3, (r,), generator=g, dtype=torch.int32).to(dev)
    for a, b in zip(col_reduce(bitmap, row, weights), col_reduce_ref(bitmap, row, weights)):
        assert torch.equal(a, b)
    cap = w * 32
    pos = torch.where(torch.rand(cap, generator=g) < 0.5,
                      torch.randint(0, r, (cap,), generator=g), -1).to(torch.int32).to(dev)
    out, flags = torch.empty_like(col), torch.tensor([1, 0], dtype=torch.int32, device=dev)
    m = label_prop_rect(row, col, bitmap)
    label_prop_update(col.clamp(max=cap - 1), m, pos, out, flags, 0)
    assert torch.equal(out, label_prop_update_ref(col.clamp(max=cap - 1), m, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["autoint", "bst", "deepfm", "dien"])
def test_gpu_recsys_matches_cpu(name, metrics_on):
    """A reduced recsys config on the card against the same parameters on
    the CPU (fp32, TF32 off on both: rtol 1e-5, atol 1e-6 for the logits,
    1e-6 for the user embeddings); ``bst_user_embedding`` launches the
    ``embedding_bag`` kernel once a call."""
    dev = _card()
    cfg = get_arch(name).make_reduced_config()
    host = getattr(recsys, f"{name}_init")(0, cfg, device="cpu")
    card = copy.deepcopy(host).to(dev)
    rng = np.random.default_rng(7)
    if name in ("deepfm", "autoint"):
        inputs = [ctr_batch(rng, 600, cfg.n_fields, np.asarray(cfg.vocab_sizes))["ids"]]
    else:
        batch = ctr_batch(rng, 600, 1, np.asarray([cfg.item_vocab]), seq_len=cfg.seq_len)
        inputs = [batch["hist"], batch["ids"][:, 0]]
    fwd = getattr(recsys, f"{name}_forward")
    np.testing.assert_allclose(fwd(card, cfg, *inputs).cpu().numpy(), fwd(host, cfg, *inputs).numpy(),
                               rtol=1e-5, atol=1e-6)
    launches = metrics.counter(EB_LAUNCHES["embedding_bag"])
    before = launches.value
    user = getattr(recsys, f"{name}_user_embedding")
    got = user(card, cfg, inputs[0])
    torch.cuda.synchronize()
    assert launches.value == before + (1 if name == "bst" else 0)
    np.testing.assert_allclose(got.cpu().numpy(), user(host, cfg, inputs[0]).numpy(), rtol=1e-6, atol=1e-6)
