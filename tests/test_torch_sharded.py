"""The sharded LM's pieces against the reference's, on the CPU: the logical
specs and their placements, the sharded MoE's two routes, the float8
cast of its dispatch and ``compressed_psum``.

The reference's sharded paths run in one subprocess with four host
devices on an ``Auto`` 2x2 mesh; the port's in four ``gloo`` processes,
spawned once for the file (``tests/_rendezvous.py``).

  * specs: each parameter's and cache leaf's logical spec equals the
    reference's (its leading ``None`` for the stacked layer axis
    dropped), through ``interop``'s names, for all 10 archs;
  * placements: ``ShardingCtx.placements`` equals the reference's
    ``PartitionSpec`` for every profile, leaf and mesh (a dimension over
    several axes in the mesh's order), and so do the ZeRO-1 moments'
    specs (``_opt_specs``);
  * the MoE: ``_apply_sharded`` (``tp_fsdp``, and a batch that does not
    divide the data axis) and ``_apply_ep2d`` (``ep2d``, ``ep2d_zero``, a
    decode-sized batch that each model row routes whole, and one large
    enough for the float8 dispatch) at capacity factor
    1.25, skewed tokens so that choices drop: outputs within 1e-5 x
    max(1, max|ref|), the aux loss within 1e-5, each rank's routing
    (choices, positions, drops) equal to the reference's routing of the
    same tokens at the same capacity, unless a gate margin is below 1e-6,
    the gradients of sum(out x r) finite and within 1e-5 x max(1,
    max|g_ref|).  The float8 case sends the tokens and the experts'
    outputs (and their cotangents back) in e4m3, 3 mantissa bits.  The
    two packages' float32 matmuls differ in the last place, so now and
    then a value sent rounds to the other e4m3 neighbour, one step (1/16
    to 1/8 of it) away: a flip.  A flip in the outputs sent back moves
    the one output element it feeds, and every element of the router's
    gradient a little; a flip in a cotangent sent back moves a block of
    its expert's gradients.  So every array the float8 payload feeds is
    held finite, with no element past 1e-3 x max(1, max|ref|) (the
    reference's loosest sharded bound) and a relative L2 error
    (|got - ref| / |ref|) of at most 1e-3, and the output also with at
    most 0.1% of its elements past 1e-5 x max(1, max|ref|); the shared
    experts' gradients, which no cast touches, within 1e-5.  Measured on
    these inputs: 3 of 262,144 outputs past 1e-5, the largest 4.3e-4 of
    max|ref| 38.4, relative L2 5.5e-6; the router's gradient 1.8e-5 (32
    of 512 past 1e-5); the experts' under 1e-6.  On five other draws of
    the inputs: at most 5 outputs past 1e-5, but one flip reached 1.6e-3
    and 2.1e-3 of max|ref| on two of them, past the 1e-3 bound, which a
    change of the inputs may therefore meet; relative L2 errors at most
    1.04e-4 (w_up, with 235 of its 16,384 elements past 1e-5).  The port
    with its dispatch left in float32 (the control, which the check must
    refuse): 202,370 outputs past 1e-5, relative L2 errors 0.030 to
    0.047.  The aux loss, computed before any cast, within 1e-5;
  * ``moe.to_e4m3`` equals ``ml_dtypes``' float8 over every bfloat16 bit
    pattern, and ``compressed_psum`` the reference's, exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

import _rendezvous
from _lm_parity import close
from repro.config import get_arch as jx_get_arch
from repro.config import reduced as jx_reduced
from repro.models import transformer as jx_transformer
from repro.models.layers import moe as jx_moe
from repro.sharding import context as jx_ctx
from repro.sharding import partitioning as jx_part
from repro_torch.config import get_arch, list_archs, reduced
from repro_torch.interop import _layer_slots
from repro_torch.models import transformer
from repro_torch.models.layers import moe
from repro_torch.sharding import partitioning
from repro_torch.sharding.context import RULE_PROFILES, ShardingCtx

TOL = 1e-5
# the float8 case (module doc): the share of the output's elements that
# may lie past TOL, the bound no element may pass, and the bound on the
# relative L2 error of each array the float8 payload feeds
F8_SHARE, F8_CEIL, F8_L2 = 1e-3, 1e-3, 1e-3
TIE_MARGIN = 1e-6
MESHES = ((("data", 2), ("model", 2)),
          (("pod", 2), ("data", 1), ("model", 2)))
# (case, profile, batch, seq)
MOE_CASES = (("tp_fsdp", "tp_fsdp", 4, 16),
             ("tp_fsdp_odd", "tp_fsdp", 3, 16),
             ("ep2d", "ep2d", 4, 16),
             ("ep2d_zero", "ep2d_zero", 4, 16),
             ("ep2d_rep", "ep2d", 2, 1),        # each model row all tokens
             ("ep2d_f8", "ep2d", 2, 2048))

_REFERENCE = """
from jax.sharding import PartitionSpec as P
from repro.models.layers import moe as moe_mod
from repro.optim.compression import compressed_psum
cfg = reduced(get_arch("deepseek-moe-16b"))
params = jax.tree.map(jnp.asarray, IN["moe_tree"])
OUT["moe"] = {}
for name, profile in IN["moe_cases"]:
    x, r = jnp.asarray(IN["moe_x"][name]), jnp.asarray(IN["moe_r"][name])
    with use_sharding(ShardingCtx(mesh, make_rules(profile))):
        out, aux = jax.jit(lambda p, x: moe_mod.apply(p, x, cfg))(params, x)
        g = jax.jit(jax.grad(
            lambda p: (moe_mod.apply(p, x, cfg)[0] * r).sum()))(params)
    OUT["moe"][name] = {"out": out, "aux": aux, "grads": g}
mesh4 = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
with jax.set_mesh(mesh4):
    OUT["psum"] = jax.shard_map(
        lambda v: compressed_psum(v[0], "data")[None], mesh=mesh4,
        in_specs=P("data"), out_specs=P("data"))(jnp.asarray(IN["psum_x"]))
"""


def _skewed(rng, shape, d, skew=3.0):
    x = rng.standard_normal(shape + (d,)).astype(np.float32)
    return x + np.float32(skew) * rng.standard_normal(d).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def sides():
    jcfg = jx_reduced(jx_get_arch("deepseek-moe-16b"))
    tree = jax.tree.map(np.asarray, jx_moe.init(jax.random.PRNGKey(0),
                                                jcfg))
    rng = np.random.default_rng(0)
    xs = {n: _skewed(rng, (b, s), jcfg.d_model) for n, _, b, s in MOE_CASES}
    inputs = {"moe_cases": [(n, p) for n, p, _, _ in MOE_CASES],
              "moe_tree": tree, "moe_leaves": _flat(tree), "moe_x": xs,
              "moe_r": {n: rng.standard_normal(x.shape).astype(np.float32)
                        for n, x in xs.items()},
              "psum_x": (rng.standard_normal((4, 37)) * np.arange(
                  1, 5)[:, None]).astype(np.float32),
              "moe_f32_control": "ep2d_f8"}
    ref = _rendezvous.Reference(_REFERENCE, inputs)
    port = _rendezvous.run_ranks(_rendezvous.sharded_ranks, inputs)
    return inputs, ref.result(), port


# ------------------------------------------------------------------ specs
def _ref_param_specs(cfg):
    """The reference's param specs by the port's names, the stacked
    layer axis's None dropped."""
    tree = jx_transformer.param_specs(cfg)
    out = {f"embed.{k}": v for k, v in tree["embed"].items()}
    out["final_norm.scale"] = tree["final_norm"]["scale"]
    for layer, si, _, i in _layer_slots(cfg):
        for part, leaves in tree["stages"][si]["sub"][i].items():
            for name, spec in _flat_specs(leaves).items():
                assert spec[0] is None
                out[f"layers.{layer}.{part}.{name}"] = tuple(spec[1:])
    return out


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_cache_specs_match_the_reference(arch):
    jcfg, cfg = jx_get_arch(arch), get_arch(arch)
    assert transformer.param_specs(cfg) == _ref_param_specs(jcfg)
    for long_context in (False, True):
        want = jx_transformer.cache_specs(jcfg, long_context=long_context)
        got = transformer.cache_specs(cfg, long_context=long_context)
        assert len(got) == cfg.num_layers
        for layer, si, _, i in _layer_slots(cfg):
            ref = {part: {n: tuple(s[1:]) for n, s in leaves.items()}
                   for part, leaves in want[si]["sub"][i].items()}
            assert got[layer] == ref, (layer, got[layer], ref)


def _placements(pspec, names):
    out = [Replicate()] * len(names)
    for i, entry in enumerate(pspec):
        for a in (entry,) if isinstance(entry, str) else entry or ():
            out[names.index(a)] = Shard(i)
    return tuple(out)


@pytest.mark.parametrize("profile", sorted(RULE_PROFILES))
def test_placements_match_the_reference_pspecs(profile):
    """Every leaf of every arch at its published widths, on 2x2 and on
    (pod=2, data=1, model=2); the ZeRO-1 moments' specs too."""
    for axes in MESHES:
        names = [n for n, _ in axes]
        ctx = ShardingCtx(axes, jx_ctx.make_rules(profile))
        ref = jx_ctx.ShardingCtx(AbstractMesh(
            tuple(s for _, s in axes), tuple(names)),
            jx_ctx.make_rules(profile))
        for arch in list_archs():
            cfg = get_arch(arch)
            shapes = partitioning.param_shapes(cfg)
            specs = transformer.param_specs(cfg)
            ospecs = partitioning._opt_specs(ctx, specs, shapes)
            jshapes = {n: jax.ShapeDtypeStruct(s, jnp.float32)
                       for n, s in shapes.items()}
            want_o = jx_part._opt_specs(ref, specs, jshapes)
            for n, spec in specs.items():
                want = ref.pspec(spec, shapes[n])
                assert ctx.pspec(spec, shapes[n]) == tuple(want)
                assert ctx.placements(spec, shapes[n]) == _placements(
                    want, names), (arch, n, spec)
                assert ospecs[n] == tuple(want_o[n]), (arch, n)


# ------------------------------------------------------------------- MoE
def _shard_tokens(case, x, rank, top_k):
    """The tokens rank (data d, model j) of a 2x2 mesh routes in
    ``case``, as the reference's shard_map bodies slice them."""
    B, _, d = x.shape
    dd, mj = divmod(rank, 2)
    if case == "tp_fsdp":
        return x[dd * B // 2:(dd + 1) * B // 2].reshape(-1, d)
    if case == "tp_fsdp_odd":
        return x.reshape(-1, d)
    if case == "ep2d_zero":
        return x[rank].reshape(-1, d)
    rows = x[dd * B // 2:(dd + 1) * B // 2].reshape(-1, d)
    n = rows.shape[0] // 2
    if rows.shape[0] % 2 or n * top_k < 4:      # no sequence split
        return rows
    return rows[mj * n:(mj + 1) * n]


def _ref_route(jp, toks, m):
    cap = jx_moe.capacity_for(m, toks.shape[0])
    _, ti, _ = jx_moe._route(jnp.asarray(jp["router"]), jnp.asarray(toks), m)
    pos = np.asarray(jx_moe._positions_in_expert(ti, m.num_experts))
    logits = toks.astype(np.float64) @ jp["router"].astype(np.float64)
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    top = -np.sort(-gates / gates.sum(-1, keepdims=True), axis=-1)
    margin = float((top[:, m.top_k - 1] - top[:, m.top_k]).min())
    return np.asarray(ti), pos, pos < cap, cap, margin


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_sharded_moe_matches_the_reference_route(sides, case):
    inputs, ref, port = sides
    want, got = ref["moe"][case], port["moe"][case]
    f8 = case == "ep2d_f8"
    _within(f"{case} out", got["out"], want["out"], f8)
    close(got["aux"], want["aux"])
    jcfg = jx_reduced(jx_get_arch("deepseek-moe-16b"))
    drops = 0
    for rank, routes in enumerate(got["routes"]):
        assert len(routes) == 1, routes
        r = routes[0]
        ti, pos, keep, cap, margin = _ref_route(
            inputs["moe_tree"], _shard_tokens(
                case, inputs["moe_x"][case], rank, jcfg.moe.top_k), jcfg.moe)
        print(f"{case} rank {rank}: capacity {cap}, drops "
              f"{int((~keep).sum())}, margin {margin:.3g}")
        assert r["capacity"] == cap
        if margin >= TIE_MARGIN:
            np.testing.assert_array_equal(r["top_idx"], ti)
            np.testing.assert_array_equal(r["pos"], pos)
            np.testing.assert_array_equal(r["keep"], keep)
        drops += int((~keep).sum())
    if case in ("tp_fsdp", "ep2d"):
        assert drops > 0, "the skewed tokens drop no choice"
    ref_grads = _flat(want["grads"])
    assert set(got["grads"]) == set(ref_grads)
    for n, g in got["grads"].items():
        # the shared experts' gradients meet no float8 cast
        _within(f"{case} grad {n}", g, ref_grads[n],
                f8 and not n.startswith("shared."), dense=True)


def _f8_refusal(what, got, want, dense=False):
    """Why the float8 check (module doc) refuses ``got``, or None; prints
    the error.  ``dense``: an array a flip moves in many elements (a
    gradient), held without the share past 1e-5."""
    got, want = np.asarray(got), np.asarray(want, dtype=np.float64)
    if not np.isfinite(got).all():
        return f"{what}: not finite"
    diff = got.astype(np.float64) - want
    err = np.abs(diff) / max(1.0, float(np.abs(want).max()))
    worst, past = float(err.max()), int((err > TOL).sum())
    l2 = float(np.linalg.norm(diff) / max(np.linalg.norm(want), 1e-30))
    print(f"{what}: max error {worst:.3g} of max|ref|, {past} of "
          f"{err.size} beyond 1e-5, relative L2 {l2:.3g}")
    if (worst > F8_CEIL or l2 > F8_L2
            or (not dense and past > F8_SHARE * err.size)):
        return (f"{what}: max {worst:.3g}, relative L2 {l2:.3g}, {past} of "
                f"{err.size} past 1e-5")
    return None


def _within(what, got, want, f8, dense=False):
    """Finite and within 1e-5 x max(1, max|want|), or for an array the
    float8 payload feeds its own check (module doc)."""
    refusal = _f8_refusal(what, got, want, dense)     # prints the error
    if f8:
        assert refusal is None, refusal
    else:
        close(got, want, TOL)


def test_float8_check_refuses_a_float32_dispatch(sides):
    """The control: the port's ``ep2d_f8`` case with its dispatch left in
    float32 fails the float8 check against the reference's float8 run."""
    _, ref, port = sides
    want, got = ref["moe"]["ep2d_f8"], port["moe_f32_control"]
    assert _f8_refusal("float32 dispatch out", got["out"],
                       want["out"]) is not None
    ref_grads = _flat(want["grads"])
    for n in ("router", "w_gate", "w_up", "w_down"):
        assert _f8_refusal(f"float32 dispatch grad {n}", got["grads"][n],
                           ref_grads[n], dense=True) is not None, n


def test_float8_cast_matches_ml_dtypes_on_every_bfloat16():
    bits = np.arange(1 << 16, dtype=np.uint16)
    with np.errstate(invalid="ignore"):     # NaN and overflow: NaN
        want = bits.view(ml_dtypes.bfloat16).astype(
            ml_dtypes.float8_e4m3fn).view(np.uint8)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    for src in (x, x.float()):
        got = moe.to_e4m3(src).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)


def test_compressed_psum_matches_the_reference(sides):
    _, ref, port = sides
    np.testing.assert_array_equal(port["psum"], np.asarray(ref["psum"])[0])
    # the same on every rank of the reference, and near the true sum
    assert (np.asarray(ref["psum"]) == np.asarray(ref["psum"])[0]).all()


@pytest.mark.parametrize("profile", ["tp_fsdp", "dp_zero1", "ep2d"])
def test_state_and_cache_shardings_match_the_reference(profile):
    """``train_state_shardings`` (params, AdamW's step, m and v) and
    ``cache_shardings`` of reduced deepseek-moe-16b and gemma3-4b on 2x2
    against the reference's ``NamedSharding``s, leaf by leaf (the stacked
    layer axis's None dropped).  Where the reference's ZeRO-1 rule splits
    a moment's stacked layer axis (``ep2d``: 2 repeats over data=2), the
    port's per-layer leaf has no such axis and takes its rule's next
    dim; ``test_placements_match_the_reference_pspecs`` holds that rule
    per layer."""
    axes = MESHES[0]
    names = [n for n, _ in axes]
    ctx = ShardingCtx(axes, jx_ctx.make_rules(profile))
    ref = jx_ctx.ShardingCtx(AbstractMesh(
        tuple(s for _, s in axes), tuple(names)), jx_ctx.make_rules(profile))
    for arch in ("deepseek-moe-16b", "gemma3-4b"):
        jcfg, cfg = jx_reduced(jx_get_arch(arch)), reduced(get_arch(arch))
        got = partitioning.train_state_shardings(ctx, cfg)
        want = jx_part.train_state_shardings(ref, jcfg)
        assert got.opt.step == _placements(want.opt.step.spec, names)
        for mine, theirs in ((got.params, want.params),
                             (got.opt.m, want.opt.m),
                             (got.opt.v, want.opt.v)):
            flat = _ref_param_specs_of(jcfg, theirs)
            assert set(mine) == set(flat)
            for n, pl in mine.items():
                if flat[n] is not None:
                    assert pl == _placements(flat[n], names), (arch, n)
        shapes = [{p: {k: tuple(t.shape) for k, t in c[p].items()}
                   for p in c} for c in transformer.init_caches(
            cfg, 4, 48, device="meta")]
        jshapes = jax.eval_shape(lambda: jx_transformer.init_caches(
            jcfg, 4, 48))
        mine = partitioning.cache_shardings(ctx, cfg, shapes)
        theirs = jx_part.cache_shardings(ref, jcfg, jshapes,
                                         long_context=False)
        for layer, si, _, i in _layer_slots(cfg):
            for part, leaves in theirs[si]["sub"][i].items():
                for k, sh in leaves.items():
                    spec = tuple(sh.spec) + (None,) * (
                        len(shapes[layer][part][k]) + 1 - len(sh.spec))
                    assert spec[0] is None
                    assert mine[layer][part][k] == _placements(
                        spec[1:], names), (arch, layer, part, k)


def _ref_param_specs_of(cfg, tree):
    """A reference tree of ``NamedSharding``s by the port's parameter
    names, each as its PartitionSpec without the stacked layer axis."""
    out = {f"embed.{k}": tuple(v.spec) for k, v in tree["embed"].items()}
    out["final_norm.scale"] = tuple(tree["final_norm"]["scale"].spec)
    for layer, si, _, i in _layer_slots(cfg):
        for part, leaves in tree["stages"][si]["sub"][i].items():
            for name, sh in _flat_leaves(leaves).items():
                s = tuple(sh.spec)
                # None: the stacked layer axis is split (module doc)
                out[f"layers.{layer}.{part}.{name}"] = (
                    s[1:] if not s or s[0] is None else None)
    return out


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
