"""The port's ``parallel/`` and ``core/mesh.py`` against the JAX package's,
on the CPU.

- Ring attention over the ``seq`` axis (three mesh shapes), its refusal of
  an indivisible sequence and its bf16 output, against JAX's
  ``ring_attention`` on conftest's virtual 8-device CPU mesh; the
  context-parallel BERT forward against JAX's.
- The expert-parallel MoE FFN and its gradients against JAX's ``moe_ffn``
  from the same (bridged) weights; dropped tokens exactly zero where JAX's
  are; the refusal of an indivisible expert count.
- ``pipeline_forward`` (four and eight stages) and its gradients, and
  ``bert_pipeline_encode``, against JAX's.
- The DP + TP train step: the loss and the updated parameters against
  JAX's ``make_train_step`` from the same weights and batch, one SGD step
  (optax and ``torch.optim`` place Adam's eps differently), at JAX's own
  TP tolerance (rtol 2e-4, ``tests/test_parallel.py``); AdamW reduces the
  loss; the layout table names JAX's dims and axes.
- ``MeshConfig`` refusals, ``build_mesh`` on repeated devices, sharded
  batches, and the two-process ``gloo`` step on the CPU.

Tolerances: JAX's own tests' for each function (2e-5 attention and
pipeline forward, 2e-4 / 2e-5 MoE, 5e-4 MoE gradients, 1e-4 pipeline
gradients); the bf16 encoders within the measured 2e-3 (a bf16 rounding
flip of a hidden state moves it by one bf16 step, 2^-8 relative); the
train step's parameters at rtol 2e-4 plus atol lr x 4e-4 (see the test).
"""

import torch_threads  # first: torch held to one CPU thread
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realtime_fraud_detection_tpu.core.mesh import MeshConfig as JMeshConfig
from realtime_fraud_detection_tpu.core.mesh import build_mesh as jbuild_mesh
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.parallel import context as jcontext
from realtime_fraud_detection_tpu.parallel import experts as jexperts
from realtime_fraud_detection_tpu.parallel import layouts as jlayouts
from realtime_fraud_detection_tpu.parallel import pipeline as jpipeline
from realtime_fraud_detection_tpu.parallel import train as jtrain
from realtime_fraud_detection_tpu_torch.bridge import params_from_numpy
from realtime_fraud_detection_tpu_torch.core.mesh import (
    MeshConfig,
    P,
    build_mesh,
    pad_batch_to_mesh,
    shard_batch,
    tree_leaves,
    tree_map,
)
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, bert_encode
from realtime_fraud_detection_tpu_torch.parallel import (
    MoEConfig,
    bert_context_parallel_predict,
    bert_pipeline_encode,
    init_train_state,
    joint_loss,
    make_train_step,
    moe_ffn,
    moe_ffn_reference,
    neural_param_shardings,
    pipeline_forward,
    ring_attention,
    shard_train_batch,
    stack_stage_params,
)
from realtime_fraud_detection_tpu_torch.parallel.train import (
    run_two_process_step,
    tiny_train_setup,
)

CPU8 = ["cpu"] * 8
ENCODER_TOL = 2e-3
TRAIN_LR = 0.1
# a bf16 step (2^-8) of a gradient component of 0.1, times the rate; the
# largest gap measured on the CPU was 1.64e-5 (two of 12,288 BERT weights)
TRAIN_ATOL = TRAIN_LR * 4e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


# ---------------------------------------------------------------- the mesh
def test_mesh_config_resolves_and_refuses_as_jax():
    for cfg, n in ((MeshConfig(), 8), (MeshConfig(model=2), 8), (MeshConfig(seq=4), 8),
                   (MeshConfig(data=1, model=8), 8)):
        j = JMeshConfig(data=cfg.data, model=cfg.model, seq=cfg.seq)
        assert cfg.resolve(n) == j.resolve(n)
    for cfg, n in ((MeshConfig(model=3), 8), (MeshConfig(data=3, model=2), 8)):
        with pytest.raises(ValueError) as got:
            cfg.resolve(n)
        with pytest.raises(ValueError) as want:
            JMeshConfig(data=cfg.data, model=cfg.model, seq=cfg.seq).resolve(n)
        assert str(got.value) == str(want.value)


def test_build_mesh_on_repeated_devices_and_sharded_batch():
    mesh = build_mesh(MeshConfig(model=2), CPU8)
    assert mesh.shape == dict(jbuild_mesh(JMeshConfig(model=2)).shape)
    assert mesh.size == 8 and all(s is None for s in mesh.streams.flat)
    assert mesh.group((1, 0, 0), "model") == [(1, 0, 0), (1, 1, 0)]
    assert pad_batch_to_mesh(3, mesh) == 4 and pad_batch_to_mesh(0, mesh) == 4
    x = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    sharded = shard_batch(mesh, {"x": x})["x"]
    assert sharded.shape == (8, 3)           # padded up, row 0 repeated
    full = sharded.gather().numpy()
    np.testing.assert_array_equal(full[:5], x)
    np.testing.assert_array_equal(full[5:], np.repeat(x[:1], 3, axis=0))
    # positions that hold the same block on one device share one tensor
    assert sharded.shards[(0, 0, 0)] is sharded.shards[(0, 1, 0)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh()


def test_collectives_equal_jax_under_shard_map():
    from realtime_fraud_detection_tpu.parallel import collectives as jcoll
    from realtime_fraud_detection_tpu_torch.parallel import collectives as coll

    x = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)

    def body(c):
        def fn(xs):
            return (c.psum_data(xs), c.pmean_data(xs), c.all_gather_seq(xs, axis=1),
                    c.reduce_scatter_data(xs, axis=0), c.ppermute_seq(xs),
                    xs + (10 * c.seq_index() + c.seq_size()))
        return fn

    def specs(p):
        return (p(None, "seq"), p(None, "seq"), p("data", None), p("data", "seq"),
                p("data", "seq"), p("data", "seq"))

    from jax.sharding import PartitionSpec as JP

    jmesh = jbuild_mesh(JMeshConfig(data=2, seq=4))
    want = jax.jit(jcoll.shard_map_over(jmesh, body(jcoll), in_specs=(JP("data", "seq"),),
                                        out_specs=specs(JP)))(x)
    got = coll.shard_map_over(build_mesh(MeshConfig(data=2, seq=4), CPU8), body(coll),
                              in_specs=(P("data", "seq"),), out_specs=specs(P))(_t(x))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(RuntimeError, match="only inside shard_map_over"):
        coll.psum_data(_t(x))


# ------------------------------------------------------------ ring attention
def _qkvm(b=8, h=2, s=32, d=8, pad=5, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), bool)
    mask[:, s - pad:] = False
    return q, k, v, mask


@pytest.mark.parametrize("cfg", [dict(seq=4), dict(data=1, seq=8), dict(seq=1)],
                         ids=["data2xseq4", "seq8", "data8"])
def test_ring_attention_matches_jax(cfg):
    q, k, v, mask = _qkvm()
    jmesh = jbuild_mesh(JMeshConfig(**cfg))
    want = np.asarray(jax.jit(lambda *a: jcontext.ring_attention(jmesh, *a))(q, k, v, mask))
    got = ring_attention(build_mesh(MeshConfig(**cfg), CPU8), *map(_t, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ring_attention_refuses_indivisible_and_keeps_bf16():
    mesh = build_mesh(MeshConfig(data=1, seq=8), CPU8)
    q, k, v, mask = map(_t, _qkvm(s=30, pad=0))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(mesh, q, k, v, mask)
    q, k, v, mask = _qkvm()
    got = ring_attention(build_mesh(MeshConfig(seq=4), CPU8),
                         *(_t(x).to(torch.bfloat16) for x in (q, k, v)), _t(mask))
    assert got.dtype == torch.bfloat16
    jmesh = jbuild_mesh(JMeshConfig(seq=4))
    want = jax.jit(lambda *a: jcontext.ring_attention(jmesh, *a))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), mask)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=2 ** -7)


def test_bert_context_parallel_matches_jax():
    jparams = jbert.init_bert_params(jax.random.PRNGKey(1), jbert.TINY_CONFIG)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, TINY_CONFIG.vocab_size, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), bool)
    mask[:, 28:] = False
    want = np.asarray(jcontext.bert_context_parallel_predict(
        jbuild_mesh(JMeshConfig(data=2, seq=4)), jparams, ids, mask, jbert.TINY_CONFIG))
    got = bert_context_parallel_predict(build_mesh(MeshConfig(data=2, seq=4), CPU8),
                                        params_from_numpy(_np(jparams)), _t(ids),
                                        _t(mask), TINY_CONFIG)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------- experts
def _moe(n_experts=8, capacity_factor=8.0):
    jcfg = jexperts.MoEConfig(n_experts=n_experts, d_model=16, d_hidden=32,
                              capacity_factor=capacity_factor)
    jparams = jexperts.init_moe_params(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).normal(0, 1, (64, 16)).astype(np.float32)
    cfg = MoEConfig(n_experts=n_experts, d_model=16, d_hidden=32,
                    capacity_factor=capacity_factor)
    return jcfg, jparams, cfg, params_from_numpy(_np(jparams)), x


@pytest.mark.parametrize("capacity_factor", [8.0, 0.25], ids=["no_drops", "drops"])
def test_moe_ffn_matches_jax(capacity_factor):
    jcfg, jparams, cfg, params, x = _moe(capacity_factor=capacity_factor)
    jmesh = jbuild_mesh(JMeshConfig(model=4))
    want = np.asarray(jax.jit(lambda p, xx: jexperts.moe_ffn(jmesh, p, xx, jcfg))(jparams, x))
    got = moe_ffn(build_mesh(MeshConfig(model=4), CPU8), params, _t(x), cfg).numpy()
    dropped = np.all(got == 0.0, axis=-1)
    np.testing.assert_array_equal(dropped, np.all(want == 0.0, axis=-1))
    assert dropped.any() == (capacity_factor < 1) and not dropped.all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    if capacity_factor > 1:
        np.testing.assert_allclose(got, moe_ffn_reference(params, _t(x)).numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_moe_ffn_gradients_match_jax():
    jcfg, jparams, cfg, params, x = _moe()
    jmesh = jbuild_mesh(JMeshConfig(model=4))
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(
        jexperts.moe_ffn(jmesh, p, x, jcfg) ** 2)))(jparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    (moe_ffn(build_mesh(MeshConfig(model=4), CPU8), leaves, _t(x), cfg) ** 2).mean().backward()
    for key in ("w1", "b1", "w2", "b2", "router"):
        np.testing.assert_allclose(leaves[key].grad.numpy(), np.asarray(jgrads[key]),
                                   rtol=5e-4, atol=1e-6, err_msg=key)


def test_moe_ffn_refuses_indivisible_experts():
    _, _, cfg, params, x = _moe(n_experts=6)
    with pytest.raises(ValueError, match="divisible"):
        moe_ffn(build_mesh(MeshConfig(model=4), CPU8), params, _t(x), cfg)


# --------------------------------------------------------------- pipeline
def _stages(n_stages, n_micro=8, mb=4, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    per = [{"w": rng.normal(0, 0.3, (dim, dim)).astype(np.float32),
            "b": rng.normal(0, 0.1, (dim,)).astype(np.float32)} for _ in range(n_stages)]
    return per, rng.normal(0, 1, (n_micro, mb, dim)).astype(np.float32)


@pytest.mark.parametrize("n_stages,cfg", [(4, dict(model=4)), (8, dict(data=1, model=8))],
                         ids=["data2xpipe4", "pipe8"])
def test_pipeline_forward_matches_jax(n_stages, cfg):
    per, x = _stages(n_stages, n_micro=2 * n_stages)
    jmesh = jbuild_mesh(JMeshConfig(**cfg))
    jstage = lambda p, h: jax.nn.relu(h @ p["w"] + p["b"])          # noqa: E731
    want = np.asarray(jax.jit(lambda p, xx: jpipeline.pipeline_forward(
        jmesh, jstage, p, xx))(jpipeline.stack_stage_params(
            [jax.tree_util.tree_map(jnp.asarray, p) for p in per]), x))
    stage = lambda p, h: torch.relu(h @ p["w"] + p["b"])             # noqa: E731
    got = pipeline_forward(build_mesh(MeshConfig(**cfg), CPU8), stage,
                           stack_stage_params([params_from_numpy(p) for p in per]), _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_pipeline_gradients_match_jax():
    per, x = _stages(4, n_micro=6)
    jmesh = jbuild_mesh(JMeshConfig(model=4))
    jstage = lambda p, h: jax.nn.relu(h @ p["w"] + p["b"])          # noqa: E731
    jstack = jpipeline.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                                           for p in per])
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(
        jpipeline.pipeline_forward(jmesh, jstage, p, x) ** 2)))(jstack)
    stack = tree_map(lambda t: t.clone().requires_grad_(True),
                     stack_stage_params([params_from_numpy(p) for p in per]))
    stage = lambda p, h: torch.relu(h @ p["w"] + p["b"])             # noqa: E731
    (pipeline_forward(build_mesh(MeshConfig(model=4), CPU8), stage, stack, _t(x))
     ** 2).mean().backward()
    for key in ("w", "b"):
        np.testing.assert_allclose(stack[key].grad.numpy(), np.asarray(jgrads[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_bert_pipeline_encode_matches_jax_and_sequential():
    jparams = jbert.init_bert_params(jax.random.PRNGKey(5), jbert.TINY_CONFIG)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, TINY_CONFIG.vocab_size, (8, 16)).astype(np.int32)
    mask = rng.random((8, 16)) > 0.3
    mask[:, 0] = True
    want = np.asarray(jax.jit(lambda p, i, m: jpipeline.bert_pipeline_encode(
        jbuild_mesh(JMeshConfig(model=2)), p, i, m, jbert.TINY_CONFIG, n_micro=4))(
            jparams, ids, mask))
    params = params_from_numpy(_np(jparams))
    got = bert_pipeline_encode(build_mesh(MeshConfig(model=2), CPU8), params, _t(ids),
                               _t(mask), TINY_CONFIG, n_micro=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENCODER_TOL)
    # the schedule itself changes nothing: the sequential encoder, exactly
    np.testing.assert_array_equal(got.numpy(),
                                  bert_encode(params, _t(ids), _t(mask), TINY_CONFIG).numpy())
    with pytest.raises(ValueError, match="n_micro"):
        bert_pipeline_encode(build_mesh(MeshConfig(model=2), CPU8), params, _t(ids),
                             _t(mask), TINY_CONFIG, n_micro=3)


# ------------------------------------------------------------ the train step
def _jax_train(b, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    from realtime_fraud_detection_tpu.models.gnn import init_gnn_params
    from realtime_fraud_detection_tpu.models.lstm import init_lstm_params

    jparams = {"lstm": init_lstm_params(k1, feature_dim=64, hidden=32, head_hidden=16),
               "gnn": init_gnn_params(k2, node_dim=16, txn_dim=64, hidden=16,
                                      head_hidden=16),
               "bert": jbert.init_bert_params(k3, jbert.TINY_CONFIG)}
    _, batch = tiny_train_setup(b, seed=seed)
    return jparams, batch


def test_train_step_matches_jax_one_sgd_step():
    jparams, batch = _jax_train(16)
    jmesh = jbuild_mesh(JMeshConfig(model=2))
    opt = optax.sgd(TRAIN_LR)
    jstate = jtrain.init_train_state(jmesh, jparams, opt)
    jbatch = jtrain.TrainBatch(**{f: getattr(batch, f) for f in batch.__dataclass_fields__})
    jnew, jm = jtrain.make_train_step(opt, jbert.TINY_CONFIG, donate=False)(
        jstate, jtrain.shard_train_batch(jmesh, jbatch))
    state = init_train_state(build_mesh(MeshConfig(model=2), CPU8),
                             params_from_numpy(_np(jparams)),
                             lambda ps: torch.optim.SGD(ps, lr=TRAIN_LR))
    state, m = make_train_step(bert_config=TINY_CONFIG)(state, batch)
    for key in ("loss", "lstm", "gnn", "bert"):
        np.testing.assert_allclose(m[key], float(jm[key]), rtol=2e-4, err_msg=key)
    got = tree_leaves(state.params)
    want = jax.tree_util.tree_leaves(_np(jnew.params))
    assert len(got) == len(want) and state.step == 1
    # zero-initialised biases move by lr x gradient alone, and the backward
    # of the bf16-rounded products (rounded as JAX rounds them) puts a few
    # gradient components a bf16 step apart: atol lr x 4e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=2e-4, atol=TRAIN_ATOL)


def test_train_step_loss_matches_single_position_and_adamw_descends():
    params, batch = tiny_train_setup(16)
    state = init_train_state(build_mesh(MeshConfig(model=2), CPU8), params,
                             lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4))
    w0 = state.params["lstm"]["w_gates"].detach().clone()
    single = joint_loss(tree_map(torch.as_tensor, params), batch, TINY_CONFIG)[0]
    step = make_train_step(bert_config=TINY_CONFIG)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    np.testing.assert_allclose(m1["loss"], float(single), rtol=2e-5)
    sharded = shard_train_batch(state.mesh, batch)
    assert sharded.labels.shape == (16,) and len(sharded.labels.shards) == 8
    np.testing.assert_array_equal(sharded.history.gather().numpy(), batch.history)
    assert np.isfinite(m1["loss"]) and m2["loss"] < m1["loss"] and state.step == 2
    assert not torch.allclose(w0, state.params["lstm"]["w_gates"])


def test_neural_param_layout_names_jax_dims_and_axes():
    jparams, _ = _jax_train(8)
    want = jax.tree_util.tree_map(lambda s: P(*s.spec), jtrain.neural_param_shardings(
        jbuild_mesh(JMeshConfig(model=2)), jparams))
    got = tree_map(lambda s: s.spec, neural_param_shardings(
        build_mesh(MeshConfig(model=2), CPU8), params_from_numpy(_np(jparams))))
    assert got == want and len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(jparams))
    layer = jlayouts.bert_layer_specs()
    assert P(*layer["q"]["w"]) == P(None, "model") and P(*layer["o"]["w"]) == P("model")


def test_two_process_gloo_step_on_the_cpu():
    out = run_two_process_step(2, 2, "cpu", env=torch_threads.spawn_env())
    assert out["passed"], out
    assert [r["process"] for r in out["processes"]] == [0, 1]
    assert all(r["mesh"] == {"data": 2, "model": 2, "seq": 1} for r in out["processes"])
    # both processes saw the same averaged step
    assert out["processes"][0]["loss"] == out["processes"][1]["loss"]
