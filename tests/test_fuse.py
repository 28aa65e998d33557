"""Graph-optimization pass tests (``bigdl_tpu/nn/fuse.py``): sibling-conv
merging must be exact — same outputs, same gradients, merged parameter
packing — across the Inception block shapes it exists for
(``models/inception/Inception_v1.scala`` inception fn)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bigdl_tpu.nn as nn
from bigdl_tpu.nn.fuse import merge_sibling_convs, optimize_for_tpu
from bigdl_tpu.models.inception import build_inception_v1, inception_layer_v1
from bigdl_tpu.nn.module import state_dict
from bigdl_tpu.utils.rng import RNG


def _forward(m, x):
    return np.asarray(m.forward(jnp.asarray(x)))


def test_inception_block_merge_exact():
    RNG.set_seed(0)
    block = inception_layer_v1(192, [[64], [96, 128], [16, 32], [32]], "3a/")
    x = np.random.randn(2, 192, 14, 14).astype(np.float32)
    ref = _forward(block, x)
    fused = merge_sibling_convs(block)
    # merging regroups the GEMM tiling, so results are close, not
    # bit-identical
    np.testing.assert_allclose(_forward(fused, x), ref, rtol=1e-5, atol=1e-6)
    # three 1x1-leading branches merged into one conv; pool branch kept
    outer = fused.layers
    assert len(outer) == 2
    merged_conv = outer[0].get(0)
    assert isinstance(merged_conv, nn.SpatialConvolution)
    assert merged_conv.n_output_plane == 64 + 96 + 16


def test_merge_preserves_gradients():
    RNG.set_seed(1)
    block = inception_layer_v1(64, [[16], [24, 32], [8, 16], [16]], "g/")
    x = np.random.randn(2, 64, 9, 9).astype(np.float32)
    gy = np.random.randn(2, 16 + 32 + 16 + 16, 9, 9).astype(np.float32)
    g_ref = np.asarray(block.backward(jnp.asarray(x), jnp.asarray(gy)))
    RNG.set_seed(1)
    block2 = merge_sibling_convs(
        inception_layer_v1(64, [[16], [24, 32], [8, 16], [16]], "g/"))
    g_fused = np.asarray(block2.backward(jnp.asarray(x), jnp.asarray(gy)))
    np.testing.assert_allclose(g_fused, g_ref, rtol=1e-5, atol=1e-6)


def test_merge_param_count_preserved():
    RNG.set_seed(2)
    plain = inception_layer_v1(192, [[64], [96, 128], [16, 32], [32]], "p/")
    n_plain = sum(int(np.prod(v.shape)) for v in state_dict(plain).values())
    fused = merge_sibling_convs(
        inception_layer_v1(192, [[64], [96, 128], [16, 32], [32]], "p/"))
    n_fused = sum(int(np.prod(v.shape)) for v in state_dict(fused).values())
    assert n_plain == n_fused


def test_full_model_merge_and_train_step():
    RNG.set_seed(3)
    model = optimize_for_tpu(build_inception_v1(10))
    import bigdl_tpu.optim as optim
    from bigdl_tpu.parallel.train_step import TrainStep

    step = TrainStep(model, nn.ClassNLLCriterion(),
                     optim.SGD(learning_rate=0.01))
    x = jnp.asarray(np.random.randn(2, 3, 224, 224).astype(np.float32))
    y = jnp.asarray(np.random.randint(0, 10, 2))
    loss = step.run(x, y, jax.random.key(0))
    assert np.isfinite(float(loss))


def test_no_merge_when_signatures_differ():
    c = nn.Concat(1)
    c.add(nn.SpatialConvolution(8, 4, 1, 1))
    c.add(nn.SpatialConvolution(8, 4, 3, 3, 1, 1, 1, 1))  # different kernel
    merge_sibling_convs(c)
    assert len(c.layers) == 2
    assert all(isinstance(b, nn.SpatialConvolution) for b in c.layers)


def test_no_merge_on_frozen_or_regularized():
    from bigdl_tpu.optim.regularizer import L2Regularizer

    c = nn.Concat(1)
    c.add(nn.SpatialConvolution(8, 4, 1, 1))
    frozen = nn.SpatialConvolution(8, 4, 1, 1)
    frozen.freeze()
    c.add(frozen)
    merge_sibling_convs(c)
    assert len(c.layers) == 2  # frozen branch blocks the merge

    c2 = nn.Concat(1)
    c2.add(nn.SpatialConvolution(8, 4, 1, 1,
                                 w_regularizer=L2Regularizer(1e-4)))
    c2.add(nn.SpatialConvolution(8, 4, 1, 1))
    merge_sibling_convs(c2)
    assert len(c2.layers) == 2


def test_merge_wrong_axis_skipped():
    c = nn.Concat(2)  # concat along H, not channels
    c.add(nn.SpatialConvolution(8, 4, 1, 1))
    c.add(nn.SpatialConvolution(8, 4, 1, 1))
    merge_sibling_convs(c)
    assert len(c.layers) == 2


def _bn_with_stats(ch, seed):
    r = np.random.default_rng(seed)
    bn = nn.SpatialBatchNormalization(ch)
    bn.weight = jnp.asarray(r.normal(1.0, 0.2, ch).astype(np.float32))
    bn.bias = jnp.asarray(r.normal(0.0, 0.1, ch).astype(np.float32))
    bn.running_mean = jnp.asarray(r.normal(0.0, 0.5, ch).astype(np.float32))
    bn.running_var = jnp.asarray(r.uniform(0.5, 2.0, ch).astype(np.float32))
    return bn


def test_fold_batchnorm_matches_eval_forward():
    from bigdl_tpu.nn.fuse import fold_batchnorm

    RNG.set_seed(4)
    model = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1), _bn_with_stats(8, 0),
        nn.ReLU(True),
        nn.SpatialConvolution(8, 6, 1, 1), _bn_with_stats(6, 1))
    model.evaluate()
    x = np.random.randn(2, 3, 10, 10).astype(np.float32)
    ref = _forward(model, x)
    fold_batchnorm(model)
    assert len(model.layers) == 3  # both BNs folded away
    np.testing.assert_allclose(_forward(model, x), ref, rtol=1e-4, atol=1e-5)


def test_fold_batchnorm_nested_containers():
    from bigdl_tpu.nn.fuse import fold_batchnorm

    RNG.set_seed(5)
    inner = nn.Sequential(nn.SpatialConvolution(4, 4, 3, 3, 1, 1, 1, 1),
                          _bn_with_stats(4, 2), nn.ReLU(True))
    model = nn.Sequential(nn.Concat(1).add(inner).add(nn.Identity()))
    model.evaluate()
    x = np.random.randn(2, 4, 6, 6).astype(np.float32)
    ref = _forward(model, x)
    fold_batchnorm(model)
    assert len(inner.layers) == 2
    np.testing.assert_allclose(_forward(model, x), ref, rtol=1e-4, atol=1e-5)


def test_fold_batchnorm_biasless_conv():
    """conv(bias=False)+BN — the conventional pairing — folds by
    materializing the bias."""
    from bigdl_tpu.nn.fuse import fold_batchnorm

    RNG.set_seed(7)
    model = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, with_bias=False),
        _bn_with_stats(8, 4))
    model.evaluate()
    x = np.random.randn(2, 3, 10, 10).astype(np.float32)
    ref = _forward(model, x)
    fold_batchnorm(model)
    assert len(model.layers) == 1
    assert model.get(0).with_bias
    np.testing.assert_allclose(_forward(model, x), ref, rtol=1e-4, atol=1e-5)


def test_graph_sibling_merge_exact():
    """The DAG form (imported models): same-input fan-out convs merge
    into one node; consumers see Narrow slices."""
    from bigdl_tpu.nn.fuse import merge_sibling_convs
    from bigdl_tpu.nn.graph import Graph, Input

    RNG.set_seed(11)
    def build():
        inp = Input(name="in")
        b1 = nn.SpatialConvolution(16, 8, 1, 1).set_name("b1").inputs(inp)
        b2 = nn.SpatialConvolution(16, 12, 1, 1).set_name("b2").inputs(inp)
        b2b = nn.SpatialConvolution(12, 24, 3, 3, 1, 1, 1, 1)\
            .set_name("b2b").inputs(nn.ReLU(True).inputs(b2))
        b3 = nn.SpatialConvolution(16, 4, 1, 1).set_name("b3").inputs(inp)
        pool = nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).inputs(inp)
        join = nn.JoinTable(1).inputs(b1, b2b, b3, pool)
        return Graph(inp, join)

    x = np.random.randn(2, 16, 7, 7).astype(np.float32)
    RNG.set_seed(11)
    ref = _forward(build(), x)
    RNG.set_seed(11)
    fused = merge_sibling_convs(build())
    np.testing.assert_allclose(_forward(fused, x), ref, rtol=1e-5, atol=1e-6)
    # the three same-input 1x1 convs became ONE conv node
    n_convs = sum(1 for m in fused.layers
                  if isinstance(m, nn.SpatialConvolution))
    assert n_convs == 2  # merged(8+12+4) + b2b
    # gradients flow through the rewritten DAG
    gy = np.random.randn(2, 8 + 24 + 4 + 16, 7, 7).astype(np.float32)
    g = fused.backward(jnp.asarray(x), jnp.asarray(gy))
    assert np.asarray(g).shape == x.shape


def test_optimize_for_tpu_returns_rebuilt_graph():
    """optimize_for_tpu must propagate merge_sibling_convs' REBUILT
    Graph — returning the surgically-mutated original (stale topo order)
    produced a KeyError at forward time."""
    from bigdl_tpu.nn.fuse import optimize_for_tpu
    from bigdl_tpu.nn.graph import Graph, Input

    RNG.set_seed(13)
    inp = Input(name="in")
    a = nn.SpatialConvolution(6, 4, 1, 1).inputs(inp)
    b = nn.SpatialConvolution(6, 5, 1, 1).inputs(inp)
    join = nn.JoinTable(1).inputs(a, b)
    g = Graph(inp, join)
    x = np.random.randn(2, 6, 5, 5).astype(np.float32)
    ref = _forward(g, x)
    opt = optimize_for_tpu(g)
    assert opt is not g  # rebuilt root
    np.testing.assert_allclose(_forward(opt, x), ref, rtol=1e-5, atol=1e-6)


def test_graph_merge_unbatched_input():
    """SpatialConvolution supports unbatched CHW inputs; the Narrow
    slices must too (negative channel axis)."""
    from bigdl_tpu.nn.fuse import merge_sibling_convs
    from bigdl_tpu.nn.graph import Graph, Input

    RNG.set_seed(14)
    def build():
        inp = Input(name="in")
        a = nn.SpatialConvolution(6, 4, 1, 1).inputs(inp)
        b = nn.SpatialConvolution(6, 5, 1, 1).inputs(inp)
        return Graph(inp, nn.JoinTable(0).inputs(a, b))

    x3 = np.random.randn(6, 5, 5).astype(np.float32)  # CHW, no batch
    RNG.set_seed(14)
    ref = _forward(build(), x3)
    RNG.set_seed(14)
    fused = merge_sibling_convs(build())
    np.testing.assert_allclose(_forward(fused, x3), ref,
                               rtol=1e-5, atol=1e-6)


def test_graph_merge_inner_graph_reregistered():
    """An inner Graph rebuilt by the recursion must be re-registered in
    the outer Graph's module table, or training/state_dict would keep the
    dead pre-merge weights."""
    from bigdl_tpu.nn.fuse import merge_sibling_convs
    from bigdl_tpu.nn.graph import Graph, Input
    from bigdl_tpu.nn.module import state_dict

    RNG.set_seed(15)
    i_in = Input(name="i")
    ia = nn.SpatialConvolution(4, 3, 1, 1).inputs(i_in)
    ib = nn.SpatialConvolution(4, 2, 1, 1).inputs(i_in)
    inner = Graph(i_in, nn.JoinTable(1).inputs(ia, ib))

    o_in = Input(name="o")
    wrapped = inner.inputs(o_in)
    outer = Graph(o_in, nn.ReLU(True).inputs(wrapped))

    x = np.random.randn(2, 4, 5, 5).astype(np.float32)
    ref = _forward(outer, x)
    fused = merge_sibling_convs(outer)
    np.testing.assert_allclose(_forward(fused, x), ref, rtol=1e-5, atol=1e-6)
    # the LIVE merged conv's parameters are discoverable for training
    shapes = [tuple(v.shape) for v in state_dict(fused, kind="param").values()]
    assert (5, 4, 1, 1) in shapes, shapes  # merged 3+2 output channels


def test_graph_merge_shared_inner_graph():
    """A Siamese inner Graph wrapped by TWO nodes must map to ONE
    rebuilt object — not a rebuilt copy for the first node and a stale
    mutated original (with a dangling merged node) for the second."""
    from bigdl_tpu.nn.fuse import merge_sibling_convs
    from bigdl_tpu.nn.graph import Graph, Input, Node

    RNG.set_seed(18)
    i_in = Input(name="i")
    ia = nn.SpatialConvolution(4, 3, 1, 1).inputs(i_in)
    ib = nn.SpatialConvolution(4, 2, 1, 1).inputs(i_in)
    inner = Graph(i_in, nn.JoinTable(1).inputs(ia, ib))

    o1, o2 = Input(name="x1"), Input(name="x2")
    n1, n2 = Node(inner), Node(inner)  # shared tower
    n1.add_prev(o1)
    n2.add_prev(o2)
    join = nn.JoinTable(1).inputs(n1, n2)
    outer = Graph([o1, o2], join)

    xs = [jnp.asarray(np.random.randn(2, 4, 5, 5).astype(np.float32))
          for _ in range(2)]
    ref = np.asarray(outer.forward(xs))
    fused = merge_sibling_convs(outer)
    np.testing.assert_allclose(np.asarray(fused.forward(xs)), ref,
                               rtol=1e-5, atol=1e-6)
    assert n1.element is n2.element  # still ONE shared tower


def test_graph_rebuild_preserves_name_and_eval_mode():
    from bigdl_tpu.nn.fuse import merge_sibling_convs
    from bigdl_tpu.nn.graph import Graph, Input

    RNG.set_seed(19)
    inp = Input(name="in")
    a = nn.SpatialConvolution(4, 3, 1, 1).inputs(inp)
    b = nn.SpatialConvolution(4, 2, 1, 1).inputs(inp)
    g = Graph(inp, nn.JoinTable(1).inputs(a, b)).set_name("backbone")
    g.evaluate()
    fused = merge_sibling_convs(g)
    assert fused.get_name() == "backbone"
    assert not fused.is_training()


def test_graph_merge_skips_cross_group_weight_sharing():
    """A conv module wrapped by nodes in DIFFERENT groups (Siamese) must
    not be repacked — merging would fork the tied weights."""
    from bigdl_tpu.nn.fuse import merge_sibling_convs
    from bigdl_tpu.nn.graph import Graph, Input, Node

    RNG.set_seed(16)
    in1, in2 = Input(name="x1"), Input(name="x2")
    shared = nn.SpatialConvolution(4, 4, 1, 1)
    n1, n2 = Node(shared), Node(shared)
    n1.add_prev(in1)
    n2.add_prev(in2)
    other = nn.SpatialConvolution(4, 6, 1, 1).inputs(in1)  # same input as n1
    join = nn.JoinTable(1).inputs(n1, n2, other)
    g = Graph([in1, in2], join)
    xs = [jnp.asarray(np.random.randn(2, 4, 5, 5).astype(np.float32))
          for _ in range(2)]
    ref = np.asarray(g.forward(xs))
    fused = merge_sibling_convs(g)
    np.testing.assert_array_equal(np.asarray(fused.forward(xs)), ref)
    # the shared conv is still ONE object wherever it appears
    convs = [m for m in fused.layers if isinstance(m, nn.SpatialConvolution)]
    assert sum(1 for c in convs if c is shared) >= 1


def test_graph_merge_skips_weight_shared_clones():
    from bigdl_tpu.nn.fuse import merge_sibling_convs
    from bigdl_tpu.nn.graph import Graph, Input, Node

    RNG.set_seed(12)
    inp = Input(name="in")
    conv = nn.SpatialConvolution(4, 4, 1, 1)
    n1, n2 = Node(conv), Node(conv)  # same module object twice
    n1.add_prev(inp)
    n2.add_prev(inp)
    join = nn.JoinTable(1).inputs(n1, n2)
    g = Graph(inp, join)
    x = np.random.randn(2, 4, 5, 5).astype(np.float32)
    ref = _forward(g, x)
    fused = merge_sibling_convs(g)
    np.testing.assert_array_equal(_forward(fused, x), ref)


@pytest.mark.parametrize("h,w,k,s,p", [
    (224, 224, 7, 2, 3),   # the ImageNet conv1 shape
    (11, 11, 2, 2, 0),     # trailing row cropped (negative hi pad)
    (15, 13, 5, 3, 2),     # stride 3, asymmetric spatial extents
])
def test_space_to_depth_input_exact(h, w, k, s, p):
    from bigdl_tpu.nn.fuse import space_to_depth_input

    RNG.set_seed(8)
    # the grad-scatter comparison below sits at rtol=1e-4 — pin the
    # GLOBAL numpy stream too, or the draw (and thus the accumulated
    # rounding) depends on whichever test ran before in the process
    np.random.seed(8)
    conv = nn.SpatialConvolution(3, 8, k, k, s, s, p, p)
    ref_model = nn.Sequential(conv, nn.ReLU(True))
    x = np.random.randn(2, 3, h, w).astype(np.float32)
    ref = _forward(ref_model, x)
    # grads of the ORIGINAL parameterization
    gy = np.random.randn(*ref.shape).astype(np.float32)
    ref_model.zero_grad_parameters()
    ref_model.backward(jnp.asarray(x), jnp.asarray(gy))
    g_ref = np.asarray(conv._grads["weight"])

    RNG.set_seed(8)
    conv2 = nn.SpatialConvolution(3, 8, k, k, s, s, p, p)
    model = space_to_depth_input(nn.Sequential(conv2, nn.ReLU(True)))
    out = _forward(model, x)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)

    # training equivalence: dead slots stay zero, live slots get the
    # SAME gradients as the original packing
    inner = model.get(0)
    new_conv = inner.get(1)
    model.zero_grad_parameters()
    model.backward(jnp.asarray(x), jnp.asarray(gy))
    gw = np.asarray(new_conv._grads["weight"])
    mask = np.asarray(new_conv.weight_mask)[0]
    assert np.all(gw[:, mask == 0] == 0), "dead slots received gradient"
    # scatter the original grad into the repacked layout and compare
    kp = -(-k // s)
    for a_h in range(s):
        for a_w in range(s):
            for j_h in range(kp):
                dy = s * j_h + a_h
                if dy >= k:
                    continue
                for j_w in range(kp):
                    dx = s * j_w + a_w
                    if dx >= k:
                        continue
                    ch = (np.arange(3) * s + a_h) * s + a_w
                    # atol scales with the grad magnitude: a near-zero
                    # element is the CANCELLATION of ~h*w products of
                    # O(max|g|) — holding it to 1e-5 absolute asserts
                    # more precision than the f32 sum carries
                    np.testing.assert_allclose(
                        gw[:, ch, j_h, j_w], g_ref[:, :, dy, dx],
                        rtol=1e-4,
                        atol=1e-6 * max(1.0, np.abs(g_ref).max()))


def test_space_to_depth_on_graph_input_conv():
    """Imported DAGs: the conv1 node fed by an Input gets the s2d repack
    (element swapped for the pad+masked-conv Sequential)."""
    from bigdl_tpu.nn.fuse import optimize_for_tpu
    from bigdl_tpu.nn.graph import Graph, Input

    RNG.set_seed(17)
    def build():
        inp = Input(name="in")
        c1 = nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3).inputs(inp)
        r = nn.ReLU(True).inputs(c1)
        deep = nn.SpatialConvolution(8, 6, 3, 3, 2, 2, 1, 1).inputs(r)
        return Graph(inp, deep)

    x = np.random.randn(2, 3, 32, 32).astype(np.float32)
    RNG.set_seed(17)
    ref = _forward(build(), x)
    RNG.set_seed(17)
    opt = optimize_for_tpu(build())
    np.testing.assert_allclose(_forward(opt, x), ref, rtol=1e-5, atol=1e-6)
    # conv1 repacked, deep conv (8 channels) untouched
    kinds = [type(m).__name__ for m in opt.layers]
    assert "Sequential" in kinds and kinds.count("SpatialConvolution") == 1


def test_space_to_depth_skips_wide_input_convs():
    from bigdl_tpu.nn.fuse import space_to_depth_input

    model = nn.Sequential(nn.SpatialConvolution(64, 64, 3, 3, 2, 2, 1, 1))
    assert space_to_depth_input(model) is model
    assert isinstance(model.get(0), nn.SpatialConvolution)


def test_space_to_depth_skips_same_padding():
    """pad == -1 (SAME) has different output-size math — must not rewrite."""
    from bigdl_tpu.nn.fuse import space_to_depth_input

    model = nn.Sequential(nn.SpatialConvolution(3, 8, 7, 7, 2, 2, -1, -1))
    ref = _forward(model, np.random.randn(2, 3, 32, 32).astype(np.float32))
    assert space_to_depth_input(model) is model
    assert isinstance(model.get(0), nn.SpatialConvolution)
    assert ref.shape == (2, 8, 16, 16)


def test_space_to_depth_unbatched_input():
    from bigdl_tpu.nn.fuse import space_to_depth_input

    RNG.set_seed(9)
    conv = nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3)
    x3 = np.random.randn(3, 32, 32).astype(np.float32)
    ref = np.asarray(conv.forward(jnp.asarray(x3)))
    RNG.set_seed(9)
    model = space_to_depth_input(nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3))
    out = np.asarray(model.forward(jnp.asarray(x3)))
    assert out.shape == ref.shape == (8, 16, 16)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_space_to_depth_model_serializes():
    """optimize_for_tpu output must stay BTPU-persistable (checkpoints)."""
    from bigdl_tpu.nn.fuse import space_to_depth_input
    from bigdl_tpu.utils import module_format

    RNG.set_seed(10)
    model = space_to_depth_input(nn.Sequential(
        nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3), nn.ReLU(True)))
    x = np.random.randn(2, 3, 32, 32).astype(np.float32)
    ref = _forward(model, x)
    blob = module_format.dumps(model)
    loaded = module_format.loads(blob)
    np.testing.assert_array_equal(_forward(loaded, x), ref)


def test_fold_batchnorm_skips_non_adjacent():
    from bigdl_tpu.nn.fuse import fold_batchnorm

    RNG.set_seed(6)
    model = nn.Sequential(nn.SpatialConvolution(3, 5, 1, 1), nn.ReLU(True),
                          _bn_with_stats(5, 3))
    fold_batchnorm(model)
    assert len(model.layers) == 3  # ReLU between conv and BN: no fold


# --------------------------------------------------------------------------
# shape-invariant wiring (bigdl_tpu.analysis shape pass around the rewrites)
# --------------------------------------------------------------------------

def test_optimize_for_tpu_shape_invariant_resnet_inception():
    """Every fusion pass must prove it preserved output shapes/dtypes:
    before/after specs via the analyzer's abstract evaluation must be
    identical for the models the rewrites exist for."""
    from bigdl_tpu.analysis.shape_pass import output_spec, specs_equal
    from bigdl_tpu.models import build_resnet

    for build, spec in (
            (lambda: build_resnet(18, 100),
             jax.ShapeDtypeStruct((2, 3, 224, 224), jnp.float32)),
            (lambda: build_inception_v1(100),
             jax.ShapeDtypeStruct((2, 3, 224, 224), jnp.float32))):
        RNG.set_seed(3)
        before = output_spec(build(), spec)
        assert before is not None
        RNG.set_seed(3)
        fused = optimize_for_tpu(build(), example_input=spec)
        after = output_spec(fused, spec)
        assert specs_equal(before, after), (before, after)


def test_optimize_for_tpu_invariant_catches_broken_pass(monkeypatch):
    """The default-on invariant must actually trip when a rewrite breaks
    the model (guards against the check becoming a stub)."""
    from bigdl_tpu.nn import fuse as fuse_mod
    from bigdl_tpu.nn.fuse import ShapeInvariantError

    def breaking_pass(model):
        return nn.Sequential(model, nn.Narrow(1, 0, 1))  # chops channels

    monkeypatch.setattr(fuse_mod, "space_to_depth_input", breaking_pass)
    RNG.set_seed(4)
    block = nn.Sequential(
        nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1), nn.ReLU(True))
    with pytest.raises(ShapeInvariantError):
        fuse_mod.optimize_for_tpu(
            block, example_input=jax.ShapeDtypeStruct((2, 3, 16, 16),
                                                      jnp.float32))


def test_optimize_for_tpu_rejects_uneval_example_input():
    """An explicitly pinned example_input the model cannot abstractly
    evaluate must raise, not silently skip the invariant."""
    from bigdl_tpu.nn.fuse import ShapeInvariantError

    RNG.set_seed(6)
    block = nn.Sequential(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1))
    with pytest.raises(ShapeInvariantError, match="abstract evaluation"):
        optimize_for_tpu(block, example_input=jax.ShapeDtypeStruct(
            (2, 5, 16, 16), jnp.float32))  # 5 channels into a 3-ch conv


@pytest.mark.slow
def test_optimize_for_tpu_infers_spec_by_default():
    """No example input: the invariant still runs via inferred specs (the
    bench/tools call pattern `optimize_for_tpu(model)`)."""
    RNG.set_seed(5)
    model = optimize_for_tpu(build_inception_v1(100))
    out = model.evaluate().forward(jnp.ones((1, 3, 224, 224)))
    assert out.shape == (1, 100)
