"""Port parity for the training plane (``repro_torch.train.schedule``,
``optimizer``, ``compression``, ``trainer``, ``repro_torch.data.pipeline``)
against the JAX package.

Inputs come from numpy seeds.  Tolerances:
* schedules: rtol = atol = 1e-7 (the same fp32 operations);
* optimizers after 5 steps (parameters and state): relative 1e-6 (fp32
  state; the port's fused multiply-adds round once where the reference
  rounds twice), bf16 state: one bf16 step (2^-8 relative) of the state
  and 1e-6 of the parameters;
* codecs: payloads exact (the same int8 levels and top-k indices),
  residuals and reconstructions 1e-6;
* data batches: byte-equal;
* a training run resumed across packages: 1e-6 against the
  uninterrupted run of the package that resumed it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.data import pipeline as jpipe
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import schedule as jsched
from repro.train import trainer as jtrainer

from repro_torch.data import pipeline as tpipe
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import schedule as tsched
from repro_torch.train import trainer as ttrainer

TOL_OPT = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"a": rng.standard_normal(5).astype(np.float32)},
                       {"a": rng.standard_normal(5).astype(np.float32)}],
            "b": rng.standard_normal(()).astype(np.float32)}


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max(initial=0))))


@pytest.mark.parametrize("name", ["constant", "warmup_cosine", "warmup_linear"])
def test_schedules_match_jax(name):
    args = {"constant": (3e-4,), "warmup_cosine": (1e-3, 4, 20, 0.1), "warmup_linear": (1e-3, 4, 20, 0.2)}[name]
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in range(0, 25):
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.05),
    "sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "adam": lambda m: m.adam(1e-2),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_schedule": lambda m: m.adamw((jsched if m is jopt else tsched).warmup_cosine(1e-2, 2, 5)),
    "chain_clip": lambda m: m.chain_clip(m.adamw(1e-2), 0.5),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_jax_over_five_steps(name):
    """Every optimizer's parameters and state after 5 steps of seeded
    gradients, leaf for leaf, with the same state keys and order (the
    checkpoint paths the two packages write)."""
    params = _tree(0)
    grads = [_tree(10 + i) for i in range(5)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _torch(params)
    ts = to.init(tp)
    for g in grads:
        u, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, u)
        u, ts = to.update(_torch(g), ts, tp)
        assert topt.apply_updates(tp, u) is tp
    want, want_paths = zip(*[(x, jax.tree_util.keystr(p)) for p, x in
                             jax.tree_util.tree_flatten_with_path((jp, js))[0]])
    got, got_paths = tckpt._flatten_with_paths((tp, ts))
    assert list(want_paths) == got_paths
    assert int(ts["step"]) == 5 and ts["step"].dtype == torch.int32
    for g_, w in zip(got, want):
        _rel_close(g_.numpy(), w, TOL_OPT)


def test_adamw_bf16_state_matches_jax():
    params, grads = _tree(1), [_tree(20 + i) for i in range(5)]
    jo, to = jopt.adamw(1e-2, state_dtype=jnp.bfloat16), topt.adamw(1e-2, state_dtype=torch.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _torch(params)
    ts = to.init(tp)
    for g in grads:
        u, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, u)
        u, ts = to.update(_torch(g), ts, tp)
        topt.apply_updates(tp, u)
    assert all(m.dtype == torch.bfloat16 for m in topt.tree_leaves(ts["m"]) + topt.tree_leaves(ts["v"]))
    for g_, w in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        _rel_close(g_.numpy(), w, TOL_OPT)
    for key in ("m", "v"):
        for g_, w in zip(topt.tree_leaves(ts[key]), jax.tree_util.tree_leaves(js[key])):
            _rel_close(g_.float().numpy(), np.asarray(w, np.float32), 2.0 ** -8)


def test_adamw_update_params_matches_adamw_and_jax():
    """The fused update (chunked over the leading axis past a threshold)
    equals ``adamw``'s update + ``apply_updates``, and the reference's
    fused update."""
    params, grads = _tree(2), [_tree(30 + i) for i in range(5)]
    tp, tq = _torch(params), _torch(params)
    ts, tq_state = topt.adamw(1e-2).init(tp), topt.adamw(1e-2).init(tq)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.adamw(1e-2).init(jp)
    for g in grads:
        u, ts = topt.adamw(1e-2).update(_torch(g), ts, tp)
        topt.apply_updates(tp, u)
        tq, tq_state = topt.adamw_update_params(tq, _torch(g), tq_state, lr=1e-2, chunk_threshold_bytes=16)
        jp, js = jopt.adamw_update_params(jp, jax.tree_util.tree_map(jnp.asarray, g), js, lr=1e-2,
                                          chunk_threshold_bytes=16)
    for a, b, w in zip(topt.tree_leaves((tq, tq_state)), topt.tree_leaves((tp, ts)),
                       jax.tree_util.tree_leaves((jp, js))):
        _rel_close(a.numpy(), b.numpy(), TOL_OPT)
        _rel_close(a.numpy(), w, TOL_OPT)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    tree = _tree(3)
    want, want_norm = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    t = _torch(tree)
    got, norm = topt.clip_by_global_norm(t, max_norm)
    assert got is t  # scaled in place
    np.testing.assert_allclose(norm.numpy(), np.asarray(want_norm), rtol=1e-6)
    np.testing.assert_allclose(topt.global_norm(_torch(tree)).numpy(), np.asarray(jopt.global_norm(tree)), rtol=1e-6)
    for g_, w in zip(topt.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _rel_close(g_.numpy(), w, TOL_OPT)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_codecs_with_error_feedback_match_jax(codec):
    """Three rounds of compress with the residual fed back: the same
    payloads (int8 levels and scale, top-k indices and values), the same
    residuals, reconstructions and wire bytes."""
    jc = jcomp.int8_codec() if codec == "int8" else jcomp.topk_codec(0.1)
    tc = tcomp.int8_codec() if codec == "int8" else tcomp.topk_codec(0.1)
    rng = np.random.default_rng(4)
    shape = (7, 9)
    jr = jcomp.init_residuals({"g": jnp.zeros(shape)})["g"]
    tr = tcomp.init_residuals({"g": torch.zeros(shape)})["g"]
    assert tr.dtype == torch.float32 and tuple(tr.shape) == shape
    payloads = []
    for _ in range(3):
        g = rng.standard_normal(shape).astype(np.float32)
        jp, jr = jc.compress(jnp.asarray(g), jr)
        tp, tr = tc.compress(torch.from_numpy(g), tr)
        payloads.append(tp)
        for k in jp:
            if k == "shape":
                assert tuple(tp[k]) == tuple(jp[k])
            elif k in ("q", "idx"):
                np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            else:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tc.decompress(tp).numpy(), np.asarray(jc.decompress(jp)), rtol=1e-6, atol=1e-6)
        assert tc.wire_bytes(tp) == jc.wire_bytes(jp)
    assert tcomp.compressed_wire_bytes(tc, payloads) == 3 * jc.wire_bytes(jp)
    assert tcomp.compressed_wire_bytes(tc, payloads[0]) == jc.wire_bytes(jp)  # a dict root is one payload


@pytest.mark.parametrize("shards", [1, 2])
def test_lm_and_ctr_batches_are_byte_equal(shards):
    for step in (0, 3, 11):
        for host in range(shards):
            want = jpipe.lm_batches(5, 8, 16, 1000, host_shard=host, n_host_shards=shards)(step)
            got = tpipe.lm_batches(5, 8, 16, 1000, host_shard=host, n_host_shards=shards)(step)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
            for seq_len in (0, 6):
                want = jpipe.ctr_batches(2, 12, [50, 7, 300], seq_len=seq_len, host_shard=host,
                                         n_host_shards=shards)(step)
                got = tpipe.ctr_batches(2, 12, [50, 7, 300], seq_len=seq_len, host_shard=host,
                                        n_host_shards=shards)(step)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    data = np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32)
    for step in (0, 1):
        want, got = jpipe.clustering_batches(data, 10, 3)(step), tpipe.clustering_batches(data, 10, 3)(step)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes()


def test_prefetcher_keeps_the_order():
    make = tpipe.lm_batches(1, 2, 4, 100)
    pf = tpipe.Prefetcher(make, depth=3, start_step=5)
    try:
        for i in range(5, 12):
            step, batch = next(pf)
            assert step == i
            assert batch["tokens"].tobytes() == make(i)["tokens"].tobytes()
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# train_loop: resume across packages
# ---------------------------------------------------------------------------

# the target and inputs keep every gradient away from 0 (Adam's update of
# a gradient that is 0 up to rounding is +-lr: rounding noise, amplified)
_TARGET = np.linspace(-0.5, 1.5, 6).astype(np.float32)
_X = np.linspace(0.5, 1.0, 6).astype(np.float32)


def _batch(i):
    return (_X * np.float32(1 + 0.1 * i)).astype(np.float32)


def _jax_run(total, ckpt_dir, params=None):
    opt = jopt.adam(0.05)
    p = params if params is not None else {"w": jnp.zeros(6), "b": jnp.zeros(())}

    def step(params, opt_state, batch):
        loss_fn = lambda q: jnp.mean(jnp.square(q["w"] * batch + q["b"] - _TARGET))
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(g, opt_state, params)
        return jopt.apply_updates(params, updates), opt_state, {"loss": loss}

    cfg = jtrainer.TrainLoopConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=4, log_every=100)
    return jtrainer.train_loop(cfg, step, p, opt.init(p), make_batch=_batch, log=lambda s: None)


def _torch_run(total, ckpt_dir):
    opt = topt.adam(0.05)
    p = {"w": torch.zeros(6, requires_grad=True), "b": torch.zeros((), requires_grad=True)}

    def step(params, opt_state, batch):
        loss = torch.mean(torch.square(params["w"] * torch.from_numpy(batch) + params["b"]
                                       - torch.from_numpy(_TARGET)))
        g = torch.autograd.grad(loss, [params["b"], params["w"]])
        updates, opt_state = opt.update({"b": g[0], "w": g[1]}, opt_state, params)
        topt.apply_updates(params, updates)
        return params, opt_state, {"loss": loss.detach()}

    cfg = ttrainer.TrainLoopConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=4, log_every=100)
    return ttrainer.train_loop(cfg, step, p, opt.init(p), make_batch=_batch, log=lambda s: None)


def test_train_loop_resumes_a_checkpoint_the_jax_loop_wrote(tmp_path):
    """The JAX ``train_loop`` runs 10 steps with checkpoints; the port's
    resumes there (step 9) and runs to 16: its losses and final state
    equal the port's uninterrupted 16 steps, and the JAX run's first 10."""
    first = _jax_run(10, str(tmp_path / "ck"))
    resumed = _torch_run(16, str(tmp_path / "ck"))
    assert [r["step"] for r in resumed["history"]] == list(range(10, 16))
    whole = _torch_run(16, None)
    np.testing.assert_allclose([r["loss"] for r in resumed["history"]],
                               [r["loss"] for r in whole["history"][10:]], rtol=TOL_OPT, atol=TOL_OPT)
    np.testing.assert_allclose([r["loss"] for r in first["history"]],
                               [r["loss"] for r in whole["history"][:10]], rtol=TOL_OPT, atol=TOL_OPT)
    for a, b in zip(topt.tree_leaves((resumed["params"], resumed["opt_state"])),
                    topt.tree_leaves((whole["params"], whole["opt_state"]))):
        _rel_close(a.detach().numpy(), b.detach().numpy(), TOL_OPT)


def test_jax_train_loop_resumes_a_checkpoint_the_port_wrote(tmp_path):
    """The reverse: the port writes 10 steps, the JAX loop resumes to 16
    and matches its own uninterrupted run."""
    _torch_run(10, str(tmp_path / "ck"))
    resumed = _jax_run(16, str(tmp_path / "ck"))
    assert [r["step"] for r in resumed["history"]] == list(range(10, 16))
    whole = _jax_run(16, None)
    np.testing.assert_allclose([r["loss"] for r in resumed["history"]],
                               [r["loss"] for r in whole["history"][10:]], rtol=TOL_OPT, atol=TOL_OPT)
    for a, b in zip(jax.tree_util.tree_leaves((resumed["params"], resumed["opt_state"])),
                    jax.tree_util.tree_leaves((whole["params"], whole["opt_state"]))):
        _rel_close(np.asarray(a), np.asarray(b), TOL_OPT)


def test_train_loop_restores_after_repeated_failures(tmp_path):
    """A step that keeps failing past ``max_retries`` restores the last
    checkpoint into the live tensors (in place) and goes on."""
    opt = topt.sgd(0.1)
    p = {"w": torch.zeros(3)}
    fails = {"left": 0}

    def step(params, opt_state, batch):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("transient")
        u, opt_state = opt.update({"w": torch.ones(3)}, opt_state, params)
        topt.apply_updates(params, u)
        return params, opt_state, {"loss": float(params["w"][0])}

    def make_batch(i):
        if i == 6:
            fails["left"] = 3  # more than max_retries: restore, then it passes
        return i

    logs = []
    out = ttrainer.train_loop(ttrainer.TrainLoopConfig(total_steps=8, ckpt_dir=str(tmp_path), ckpt_every=4,
                                                       log_every=100, max_retries=2),
                              step, p, opt.init(p), make_batch, log=logs.append)
    assert any("restored from checkpoint step 3" in s for s in logs)
    assert out["params"]["w"] is p["w"]
    # steps 0-5 add -0.1 each, the restore goes back to step 3's -0.4, then steps 6-7
    np.testing.assert_allclose(p["w"].numpy(), np.full(3, -0.6, np.float32), rtol=1e-6)


def test_checkpoint_keeps_bf16_bits(tmp_path):
    """A bf16 tensor is saved as its 16-bit words with ``bfloat16`` in the
    manifest and read back bit for bit into a bf16 tensor."""
    import json

    x = torch.randn(5, 7).to(torch.bfloat16)
    tckpt.save_checkpoint(tmp_path, 0, {"x": x, "y": torch.arange(3)}, fsync=False)
    manifest = json.loads((tmp_path / "step_000000000000" / "manifest.json").read_text())
    assert manifest["dtypes"] == ["bfloat16", "int64"]
    tree, _ = tckpt.restore_checkpoint(tmp_path, template={"x": None, "y": None})
    back = tckpt.to_tensor(tree["x"], torch.empty(0, dtype=torch.bfloat16))
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), x.view(torch.int16))


def test_train_loop_writes_a_step_once(tmp_path):
    """The final save is skipped when the last step's checkpoint is on
    disk already: saved by ``ckpt_every`` on that step, or restored with
    no step left to run (the reference writes the same state again)."""
    import json

    def manifest_time(step):
        return json.loads((tmp_path / f"step_{step:012d}" / "manifest.json").read_text())["written_at"]

    def run(total):
        p = {"w": torch.zeros(2)}
        opt = topt.sgd(0.1)

        def step(params, opt_state, batch):
            u, opt_state = opt.update({"w": torch.ones(2)}, opt_state, params)
            topt.apply_updates(params, u)
            return params, opt_state, {"loss": 0.0}

        return ttrainer.train_loop(ttrainer.TrainLoopConfig(total_steps=total, ckpt_dir=str(tmp_path), ckpt_every=4,
                                                            log_every=100), step, p, opt.init(p), lambda i: i,
                                   log=lambda s: None)

    run(8)  # steps 3 and 7 saved by ckpt_every; 7 is the last: no second write
    written = manifest_time(7)
    out = run(8)  # resumed at step 7 with no step left
    assert out["history"] == [] and manifest_time(7) == written
    np.testing.assert_allclose(out["params"]["w"].numpy(), [-0.8, -0.8], rtol=1e-6)
    assert tckpt.list_steps(tmp_path) == [3, 7]


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "tiny_where_zero", "scaled"])
def test_smoke_step_parity_holds_the_gradients(fault):
    """``chip_smoke.cpu_step_parity`` (the recsys and GAT steps on the card
    against a CPU copy) passes the same step twice, and fails on a
    gradient of 1e-7 where the CPU's is 0 and on gradients 1% too large
    (which AdamW's first step, invariant to the gradient's scale, hides
    from the parameters)."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    init = {"w": rng.standard_normal(4).astype(np.float32), "unused": rng.standard_normal(3).astype(np.float32)}
    trees = [{k: torch.tensor(v) for k, v in init.items()} for _ in range(2)]
    opt = topt.adamw(lr=1e-3)
    states = [opt.init(t) for t in trees]

    def loss_of(tree, faulty):
        loss = torch.mean(torch.square(x @ tree["w"] - y))
        if faulty and fault == "tiny_where_zero":
            loss = loss + 1e-7 * (tree["unused"][0] - tree["unused"][0].detach())
        if faulty and fault == "scaled":
            loss = loss + 0.01 * (loss - loss.detach())
        return loss

    def step(i, faulty):
        leaves = topt.tree_leaves(trees[i])
        loss = loss_of(trees[i], faulty)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        updates, states[i] = opt.update(dict(zip(sorted(trees[i]), grads)), states[i], trees[i])  # leaves in key order
        topt.apply_updates(trees[i], updates)
        return {"loss": loss.detach()}

    ok, fields = smoke.cpu_step_parity(lambda: step(0, True), lambda: step(1, False), trees[0], trees[1],
                                       lambda: loss_of(trees[0], True), lambda: loss_of(trees[1], False))
    assert fields["loss_card"] == fields["loss_cpu"]
    assert fields["elements_zero_grad"] == 3 and fields["elements"] == 7
    assert ok is (fault is None), fields
    assert (fields["grad_max_rel_l2"] > smoke.TRAIN_GRAD_REL_L2) is (fault is not None), fields
