"""The port's ``sharding.py`` and parameter specs against the JAX
package's, in one process.

- The reference's rules (``param_spec_rules``) fitted to every leaf of
  each of the eleven configs at ``reduced()`` size, on a (data 1, model 2)
  and a (data 1, model 16) mesh: the port's ``build_param_specs`` on its
  per-layer tree equals the reference's ``build_param_specs`` on its
  stacked tree, leaf by leaf.  The meshes are stand-ins with the
  reference mesh's ``axis_names`` and ``shape`` (all the spec code reads),
  so no device is forced.
- The specs the port shards by (``model.param_specs``) for all eleven
  configs: equal to the reference's but for the leaves named in
  ``ATTN``, ``DENSE_FFN`` and ``model.MIXER_LAYOUTS``; a model axis that
  a split width does not divide is refused by name.
- The port's own layouts pinned by name: Mamba's interleaved ``x`` /
  ``z`` slice of ``w_in``, sLSTM's four gate stripes, the mLSTM's whole
  ``xu`` stripe beside its split ``z`` stripe, MLA's whole latent.
- ``logical_spec``'s divisibility fallback, against the reference's.
- ``shard_params`` then ``gather_params`` is the identity, for all
  eleven configs.
- The conjugate operations' gradients, on a two-rank model axis emulated
  by two threads, against the unsharded products.
- The collectives of one decode step on a model axis of 2, counted by a
  ``RecordingWorld``.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import sharding as jsharding  # noqa: E402
from repro.configs.base import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import model, transformer  # noqa: E402

WIDTHS = (2, 16)
#: every family runs on a model axis above 1 in the port
TP_IDS = tuple(ARCH_IDS)
#: leaves the port lays out its own way (``model.param_specs``): attention
#: by heads (the reference splits columns mid-head), a dense FFN by its
#: width (the reference's expert rules match its leaves first)
ATTN = ("mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo")
DENSE_FFN = ("ffn/w_in", "ffn/w_gate", "ffn/w_out")
CROSS = ("cross/wq", "cross/wk", "cross/wv", "cross/wo")


class _Mesh:
    """What the reference's spec code reads of a mesh."""

    def __init__(self, model_width):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": model_width}


def _ref_specs(aid, width):
    """{reference path: spec tuple} of the reduced config's params."""
    arch = jget_config(aid).reduced()
    m = _Mesh(width)
    ctx = jmodel.build_ctx(arch, m, seq_len=8, global_batch=1)
    shapes = jax.eval_shape(
        lambda: jtransformer.init_model(jax.random.PRNGKey(0), ctx))
    rules = jmodel.default_rules(m)
    with jsharding.axis_rules(rules):
        specs = jsharding.build_param_specs(
            shapes, jmodel.param_spec_rules(arch, ctx.ep))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in flat}


def _ref_key(arch, path):
    """The reference's path of a port leaf, and whether it is stacked."""
    if path[0] not in ("layers", "enc_layers"):
        return "/".join(path), False
    i, rest = int(path[1]), "/".join(path[2:])
    if path[0] == "enc_layers":
        return f"enc_groups/sub0/{rest}", True
    prefix, group, _ = transformer.layer_plan(arch)
    if i < len(prefix):
        return f"prefix{i}/{rest}", False
    return f"groups/sub{(i - len(prefix)) % len(group)}/{rest}", True


def _port_world(width):
    return mesh.recording_world((1,), model=width)


def _port_full_tree(arch, width):
    """The port's full tree on the meta device (every expert), and the EP
    spec of a (data 1, model ``width``) world."""
    ctx = model.build_ctx(arch, seq_len=8, global_batch=1, device="cpu")
    ep = model.make_ep_spec(arch, _port_world(width))
    return model.full_abstract_params(ctx), ep


def _compare(aid, width, port_specs):
    """{port path: (port spec, reference spec)} of the leaves that
    differ; the prefix layers' reference spec is its own fitting."""
    arch = get_config(aid).reduced()
    ref = _ref_specs(aid, width)
    diff = {}
    for path, spec in sharding._leaves_with_paths(port_specs):
        key, stacked = _ref_key(arch, path)
        want = ref[key]
        if stacked:
            want = want[1:]
            while want and want[-1] is None:
                want = want[:-1]
        if tuple(spec) != want:
            diff["/".join(path)] = (tuple(spec), want)
    return diff


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_rule_specs_match_reference(aid, width):
    """The reference's rules through the port's ``build_param_specs``
    give every leaf the reference's spec.  One kind of leaf differs by
    name: a prefix layer (DeepSeek-V2's first dense layer), which the
    reference fits unstacked, so its rules (written for a leading layer
    axis) land one dimension off; the port fits every layer as a stacked
    one."""
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)
    arch = get_config(aid).reduced()
    tree, ep = _port_full_tree(arch, width)
    specs = sharding.build_param_specs(
        tree, model.param_spec_rules(arch, ep),
        {"data": 1, "model": width})
    diff = _compare(aid, width, specs)
    prefix = len(transformer.layer_plan(arch)[0])
    for path in diff:
        assert path.startswith("layers/") and int(path.split("/")[1]) < \
            prefix, (path, diff[path])


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("aid", TP_IDS)
def test_sharded_specs_match_reference_but_named_leaves(aid, width):
    """``model.param_specs``, the layout the port shards by, against the
    reference's specs: equal everywhere but on the leaves of
    ``ATTN`` (self- and cross-attention, replicated where the model axis
    does not divide the query and KV heads, the reference splitting their
    columns mid-head; by heads where it does), ``DENSE_FFN`` (a dense FFN
    by its width: ``w_in``/``w_gate`` columns, ``w_out`` rows) and the
    other mixers' leaves (``model.MIXER_LAYOUTS``, each as the table
    names it).  At 16 the reduced MLA and xLSTM models' 4 heads do not
    divide: ``build_ctx`` refuses them by name."""
    arch = get_config(aid).reduced()
    world = _port_world(width)
    kinds = {s.mixer for s in transformer.layer_list(arch)}
    if width > arch.num_heads and kinds & {"mla", "mlstm", "slstm"}:
        with pytest.raises(ValueError, match="heads"):
            model.build_ctx(arch, world, seq_len=8, global_batch=1,
                            device="cpu")
        return
    ctx = model.build_ctx(arch, world, seq_len=8, global_batch=1,
                          device="cpu")
    tree = model.full_abstract_params(
        model.build_ctx(arch, seq_len=8, global_batch=1, device="cpu"))
    specs = model.param_specs(tree, ctx)
    diff = _compare(aid, width, specs)
    heads = arch.num_heads % width == 0 and arch.num_kv_heads % width == 0
    wide = arch.d_ff % width == 0
    flat = dict(sharding._leaves_with_paths(specs))
    subs = transformer.layer_list(arch)
    mixed = set()
    for path in flat:
        name = "/".join(path[-2:])
        got = flat[path]
        mixer = subs[int(path[1])].mixer if path[0] == "layers" else ""
        if mixer in model.MIXER_LAYOUTS and path[2] == "mixer":
            rest = "/".join(path[3:])
            assert got == model.MIXER_LAYOUTS[mixer].get(rest, ()), \
                (path, got)
            mixed.add("/".join(path))
        elif name in ATTN + CROSS and path[0] in ("layers", "enc_layers"):
            want = (("model",) if name.endswith("/wo") else (None, "model")) \
                if heads else ()
            assert got == want, (path, got)
        elif name in DENSE_FFN and len(path) == 4 and not arch.is_moe:
            want = (("model",) if name == "ffn/w_out" else (None, "model")) \
                if wide else ()
            assert got == want, (path, got)
    for path in diff:
        assert "/".join(path.split("/")[-2:]) in ATTN + CROSS + DENSE_FFN \
            or path in mixed, (path, diff[path])
    # at 16 the reduced model's 4 heads do not divide: the reference
    # splits them mid-head, the port replicates them
    if width == 16 and "attn" in kinds:
        assert any(p.endswith("/wq") for p in diff)


def test_logical_spec_divisibility_fallback():
    """An axis whose world extent does not divide the dimension is
    replicated (6 heads on a 16-wide model axis), as in the reference;
    no rules, no spec."""
    world = mesh.recording_world((2,), model=16)
    jm = _Mesh(16)
    jm.shape = {"data": 2, "model": 16}
    cases = [(("batch", "model"), (8, 6)), (("batch", "model"), (8, 32)),
             (("batch", None, "model"), (3, 5, 16)), (("model",), (48,))]
    assert sharding.logical_spec("batch", "model", dims=(8, 6)) == ()
    with sharding.axis_rules(model.default_rules(world)), \
            jsharding.axis_rules(jmodel.default_rules(jm)):
        for names, dims in cases:
            got = sharding.logical_spec(*names, dims=dims)
            assert got == tuple(jsharding.logical_spec(*names, dims=dims))
        assert sharding.logical_spec("batch", "model", dims=(8, 6)) == \
            ("data",)
        assert sharding.logical_spec("batch", "model", dims=(8, 32)) == \
            ("data", "model")


class _PeerWorld:
    """Model rank ``coord`` of two whose gathers read the other rank's
    leaves from ``peer`` (its model-sliced leaves in tree order)."""

    model = 2
    axis_names, axis_sizes = ("data",), (1,)

    def __init__(self, coord, peer):
        self.model_coord = coord
        self.peer = iter(peer)

    def all_gather(self, x, axes):
        other = next(self.peer)
        parts = [x, other] if self.model_coord == 0 else [other, x]
        return torch.cat(parts, 0)


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_shard_then_gather_is_identity(aid):
    """``shard_params`` at each model coordinate, then ``gather_params``
    on each: the full tree back, bit for bit; every leaf the specs slice
    holds half of each split stripe of its dimension and all of each
    whole one."""
    arch = get_config(aid).reduced()
    full_ctx = model.build_ctx(arch, seq_len=8, global_batch=1,
                               device="cpu")
    full = model.init_params(full_ctx, torch.Generator().manual_seed(0),
                             "cpu")
    trees, ctxs = [], []
    for c in (0, 1):
        world = mesh.recording_world((1,), model=2)
        world = type(world)(**{**world.__dict__, "model_coord": c})
        ctx = model.build_ctx(arch, world, seq_len=8, global_batch=1,
                              device="cpu")
        ctxs.append(ctx)
        trees.append(model.shard_params(full, ctx))
    specs = dict(sharding._leaves_with_paths(model.param_specs(full,
                                                               ctxs[0])))
    sliced = []
    for c in (0, 1):
        leaves = []
        for (path, t), (_, f) in zip(sharding._leaves_with_paths(trees[c]),
                                     sharding._leaves_with_paths(full)):
            dim = sharding.model_dim(specs[path])
            if dim is None:
                assert t.shape == f.shape
            else:
                parts = sharding.stripes_of(specs[path])
                w = f.shape[dim] // len(parts)
                assert t.shape[dim] == sum(w // 2 if p else w
                                           for p in parts), path
                leaves.append(t.movedim(dim, 0).contiguous())
        sliced.append(leaves)
    assert sliced[0], "nothing was sliced"
    for c in (0, 1):
        ctx = transformer.ModelCtx(**{**ctxs[c].__dict__,
                                      "mesh": _PeerWorld(c, sliced[1 - c])})
        back = model.gather_params(trees[c], ctx)
        for (_, a), (_, b) in zip(sharding._leaves_with_paths(back),
                                  sharding._leaves_with_paths(full)):
            assert torch.equal(a, b)


def _rank_slices(aid, **kw):
    """``(arch, full tree, [rank 0's tree, rank 1's tree])`` of a reduced
    config on a (data 1, model 2) world."""
    import dataclasses
    arch = dataclasses.replace(get_config(aid).reduced(), **kw)
    full = model.init_params(
        model.build_ctx(arch, seq_len=8, global_batch=1, device="cpu"),
        torch.Generator().manual_seed(0), "cpu")
    trees = []
    for c in (0, 1):
        world = mesh.recording_world((1,), model=2)
        world = type(world)(**{**world.__dict__, "model_coord": c})
        trees.append(model.shard_params(full, model.build_ctx(
            arch, world, seq_len=8, global_batch=1, device="cpu")))
    return arch, full, trees


def _halves(t, c, dim=-1):
    n = t.shape[dim] // 2
    return t.narrow(dim, c * n, n)


def _stripes(t, n, c, dim=-1):
    """Rank ``c``'s half of each of the ``n`` stripes of ``t``, in order."""
    return torch.cat([_halves(p, c, dim) for p in t.chunk(n, dim)], dim)


@pytest.mark.parametrize("family", ("mamba", "slstm", "mlstm", "mla"))
def test_port_layouts_pinned_by_name(family):
    """The layouts the port takes where the reference's rule would not
    run as one rank's part of the layer, leaf by leaf at each model
    coordinate ``c`` of 2:

    - Mamba: ``w_in`` [d, 2 di] packs ``x`` and ``z``; a rank takes its
      half of ``x`` and the matching half of ``z`` (the reference's
      contiguous split would give rank 0 all of ``x``); the conv, ``w_dt``
      (columns), ``b_dt``, ``A_log``, ``D`` follow those channels,
      ``w_x_dbc`` and ``w_out`` split by rows;
    - sLSTM: ``w_gates`` [d, 4 d] and ``b_gates`` are gate-major, so a
      rank's heads are four stripes, one a gate; ``r_gates`` by heads,
      ``ln`` (an RMSNorm over all of d) by channels, ``w_out`` by rows;
    - mLSTM: ``w_up``'s ``xu`` stripe whole (q, k, v and the gates read
      all of it), its ``z`` stripe split; ``wq``/``wk``/``wv`` by head
      columns, ``w_if`` / ``b_if`` the heads' input and forget gates,
      the per-head ``ln`` whole, ``w_down`` by rows;
    - MLA: ``w_q``, ``w_uk``, ``w_uv`` on their head axis, ``w_o`` by
      rows; the latent ``w_dkv``, ``kv_norm``, ``w_kr`` whole."""
    aid, kw, kind = {
        "mamba": ("jamba_v0_1_52b", {}, "mamba"),
        "slstm": ("xlstm_350m", {}, "slstm"),
        "mlstm": ("xlstm_350m", {}, "mlstm"),
        "mla": ("deepseek_v2_lite_16b", {}, "mla")}[family]
    arch, full, trees = _rank_slices(aid, **kw)
    i = [s.mixer for s in transformer.layer_list(arch)].index(kind)
    f = full["layers"][i]["mixer"]
    for c in (0, 1):
        p = trees[c]["layers"][i]["mixer"]
        if family == "mamba":
            want = {"w_in": _stripes(f["w_in"], 2, c),
                    "conv_w": _halves(f["conv_w"], c),
                    "conv_b": _halves(f["conv_b"], c),
                    "w_x_dbc": _halves(f["w_x_dbc"], c, 0),
                    "w_dt": _halves(f["w_dt"], c),
                    "b_dt": _halves(f["b_dt"], c),
                    "A_log": _halves(f["A_log"], c, 0),
                    "D": _halves(f["D"], c),
                    "w_out": _halves(f["w_out"], c, 0)}
            di = f["w_in"].shape[1] // 2
            assert torch.equal(p["w_in"][:, di // 2:],
                               f["w_in"][:, di + c * di // 2:
                                         di + (c + 1) * di // 2])
        elif family == "slstm":
            want = {"w_gates": _stripes(f["w_gates"], 4, c),
                    "b_gates": _stripes(f["b_gates"], 4, c),
                    "r_gates": _halves(f["r_gates"], c, 0),
                    "w_out": _halves(f["w_out"], c, 0)}
            assert torch.equal(p["ln"]["scale"],
                               _halves(f["ln"]["scale"], c))
        elif family == "mlstm":
            di = f["wq"].shape[0]
            want = {"w_up": torch.cat([f["w_up"][:, :di],
                                       _halves(f["w_up"][:, di:], c)], 1),
                    "wq": _halves(f["wq"], c), "wk": _halves(f["wk"], c),
                    "wv": _halves(f["wv"], c),
                    "w_if": _stripes(f["w_if"], 2, c),
                    "b_if": _stripes(f["b_if"], 2, c),
                    "w_down": _halves(f["w_down"], c, 0)}
            assert torch.equal(p["ln"]["scale"], f["ln"]["scale"])
        else:
            want = {"w_q": _halves(f["w_q"], c, 1),
                    "w_uk": _halves(f["w_uk"], c, 1),
                    "w_uv": _halves(f["w_uv"], c, 1),
                    "w_o": _halves(f["w_o"], c, 0),
                    "w_dkv": f["w_dkv"], "w_kr": f["w_kr"]}
            assert torch.equal(p["kv_norm"]["scale"],
                               f["kv_norm"]["scale"])
        for name, w in want.items():
            assert torch.equal(p[name], w), (family, name, c)


class _ThreadWorld:
    """A model axis of two ranks emulated by two threads: an all-reduce
    meets the other thread's tensor at a barrier and sums the two in
    coordinate order (the same bits on both)."""

    model = 2

    def __init__(self, coord, slots, barrier):
        self.model_coord, self.slots, self.barrier = coord, slots, barrier

    def all_reduce_sum(self, t, axes):
        assert tuple(axes) == ("model",)
        self.slots[self.model_coord] = t.detach().clone()
        self.barrier.wait()
        out = self.slots[0] + self.slots[1]
        self.barrier.wait()
        return out


def test_conjugate_operations_give_whole_gradients():
    """A layer norm, then a column-parallel and a row-parallel product
    (``copy_to_model`` before, ``reduce_from_model`` after) on each of
    two model ranks: the output and the gradients of the input, of the
    replicated norm scale and of each rank's weight slices equal the
    unsharded layer's.  Without ``copy_to_model`` the input's and the
    norm's gradients are each rank's part only."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, generator=g, dtype=torch.float64)
    scale = torch.randn(8, generator=g, dtype=torch.float64)
    w1 = torch.randn(8, 12, generator=g, dtype=torch.float64)
    w2 = torch.randn(12, 8, generator=g, dtype=torch.float64)
    r = torch.randn(6, 8, generator=g, dtype=torch.float64)

    def layer(x, s, a, b, world, copy=True):
        h = torch.nn.functional.layer_norm(x, (8,)) * s
        if copy:
            h = sharding.copy_to_model(h, world)
        y = torch.relu(h @ a) @ b
        return sharding.reduce_from_model(y, world)

    leaves = [t.clone().requires_grad_(True) for t in (x, scale, w1, w2)]
    want = layer(*leaves, None)
    (want * r).sum().backward()
    want_g = [t.grad for t in leaves]

    for copy in (True, False):
        slots, barrier, out = [None, None], threading.Barrier(2), {}

        def rank(c):
            world = _ThreadWorld(c, slots, barrier)
            mine = [x.clone(), scale.clone(), w1[:, 6 * c:6 * c + 6].clone(),
                    w2[6 * c:6 * c + 6].clone()]
            mine = [t.requires_grad_(True) for t in mine]
            y = layer(*mine, world, copy=copy)
            (y * r).sum().backward()
            out[c] = (y.detach(), [t.grad for t in mine])

        threads = [threading.Thread(target=rank, args=(c,)) for c in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for c in (0, 1):
            y, grads = out[c]
            torch.testing.assert_close(y, want.detach())
            torch.testing.assert_close(grads[2],
                                       want_g[2][:, 6 * c:6 * c + 6])
            torch.testing.assert_close(grads[3], want_g[3][6 * c:6 * c + 6])
            if copy:
                torch.testing.assert_close(grads[0], want_g[0])
                torch.testing.assert_close(grads[1], want_g[1])
            else:
                assert not torch.allclose(grads[0], want_g[0])
        if not copy:
            torch.testing.assert_close(out[0][1][1] + out[1][1][1],
                                       want_g[1])


@pytest.mark.parametrize("aid", ("gpt3_medium_moe", "minitron_4b"))
def test_decode_step_collectives_on_a_model_axis(aid):
    """One decode step on a (data 1, model 2) world emulated by a
    ``RecordingWorld``: the embedding's all-reduce, then per layer one
    after attention and one after the FFN (the experts' through the
    gather path, whose EP axes span one rank), and one all-gather of the
    logits, all over the model axis and nothing else."""
    from repro_torch.models import decode
    arch = get_config(aid).reduced()
    world = mesh.recording_world((1,), model=2)
    ctx = model.build_ctx(arch, world, seq_len=16, global_batch=2,
                          aux_mode="none", device="cpu")
    params = model.init_params(ctx, torch.Generator().manual_seed(0), "cpu")
    cache = decode.init_cache(ctx, 2, 16, device="cpu")
    assert cache[0]["mixer"]["k"].shape[2] == arch.num_kv_heads // 2
    world.log.clear()
    with torch.no_grad():
        logits, _ = decode.decode_step(
            params, cache, torch.zeros((2, 1), dtype=torch.int32), ctx)
    assert logits.shape == (2, 1, arch.vocab_size)
    kinds = [k for k, *_ in world.log]
    assert {axes for *_, axes in world.log} == {("model",)}
    assert kinds.count("all_reduce") == 1 + 2 * arch.num_layers
    assert kinds.count("all_gather") == 1
    assert kinds[0] == "all_reduce" and kinds[-1] == "all_gather"
    assert np.prod(world.log[-1][2]) == 2 * arch.vocab_size // 2
