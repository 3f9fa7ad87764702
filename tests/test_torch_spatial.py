"""The port's spatial (image-W) mesh axis on the CPU: four ranks over gloo,
spawned once for the module (a rendezvous file in a temporary directory),
EfficientSeg-B0 in float32 at 128x256 with the same seeded flax variables
loaded into the port (``load_flax_variables``) and the JAX model:

* ``MeshSpec.resolve`` against the JAX package's on a grid of sizes;
* the halo-exchanged ``Conv2dSame`` for (k, s) in {3, 5} x {1, 2} and the
  U-Net's padded 3x3 ``Conv2d``, on 2 and 4 spatial ranks, against the
  one-device conv (1e-6 of max|.|), and the two errors a slab can raise;
* the whole forward at data 1 x spatial 2 and x spatial 4 against the
  port's one-rank forward (``multichip.HEADS_REL_F32`` of max|.|, measured
  around 6e-7) and against the JAX package's W-sharded forward on its
  virtual-device mesh (``tests/test_spatial_sharding.py``'s atol 2e-4 /
  rtol 1e-3), with the collectives one forward makes;
* the decode at data 2 x spatial 2 (two frames) against the port's one-rank
  decode and JAX's ``decode_output`` on its data x spatial mesh, by the
  rule of ``__graft_entry__.dryrun_multichip``;
* a forward whose halos are zeros, which must miss the bound by far;
* train mode, ``remat`` and int8 raising under a mesh, a one-rank mesh
  giving the plain path bit for bit, and the batch split's errors.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from instance_segmentation_torch.models import EfficientSeg, EfficientSegConfig
from instance_segmentation_torch.models import layers as tl
from instance_segmentation_torch.ops.decode import Detections
from instance_segmentation_torch.parallel import multihost, spatial
from instance_segmentation_torch.parallel.mesh import (
    Mesh, MeshSpec, batch_shard, data_shard, make_mesh,
)
from instance_segmentation_torch.serve import Predictor
from instance_segmentation_torch.tools import multichip
from instance_segmentation_torch.weights import load_flax_variables

torch.set_num_threads(2)
WORLD = 4
H, W = multichip.INFER_CHECK_HW
JAX_TOL = dict(atol=2e-4, rtol=1e-3)         # tests/test_spatial_sharding.py
CONV_REL = 1e-6
CONVS = [("same", k, s) for k in (3, 5) for s in (1, 2)] + [("padded", 3, 1)]
CPU = torch.device("cpu")
# Per forward at B0: the stem and 16 depthwise convs plus the U-Net's ten
# 3x3 convs exchange halos, 16 squeeze-and-excitation sums, P3..P5 and the
# dense heads gathered.
B0_COLLECTIVES = {"halo": 27, "all_reduce": 16, "gather": 4}
# tools/multichip.py's full-width serving run, cut to B0 f32 at 128x256, b1 and b2
SMALL, SMALL_HW = EfficientSegConfig(num_classes=8, compound_coef=0), (2 * H, 2 * W)
SMALL_BATCHES = (1, 2)


def _conv(kind, k, s, cin=4, cout=6):
    torch.manual_seed(100 * k + s)
    if kind == "same":
        conv = tl.Conv2dSame(cin, cout, k, stride=s)
    else:
        conv = tl.Conv2d(cin, cout, k, padding=(k - 1) // 2)
    return conv.eval()


def _conv_input(width=32):
    return torch.from_numpy(np.random.default_rng(7).normal(0, 1, (2, 4, 9, width))
                            .astype(np.float32))


def _frames(batch=1):
    return np.random.default_rng(0).integers(0, 255, (batch, H, W, 3), dtype=np.uint8)


def _port_model(variables):
    model = EfficientSeg(EfficientSegConfig(num_classes=8, compound_coef=0))
    load_flax_variables(model, variables)
    return model


def _forward(model, mesh):
    """The mesh's five outputs of ``_frames()`` and the collectives."""
    for kind in spatial.calls:
        spatial.calls[kind] = 0
    with torch.inference_mode(), spatial.sharded(mesh):
        out = model(batch_shard(torch.from_numpy(_frames()), mesh))
    return [t.clone() for t in out], dict(spatial.calls)


def _zero_halos(x, left, right, mesh):
    return F.pad(x, (left, right))


def _rank(rank, world, init_method, variables, out_dir):
    torch.set_num_threads(1)
    multihost.maybe_initialize("cpu", init_method=init_method, rank=rank, world_size=world)
    try:
        out = {"convs": {}}
        meshes = {2: make_mesh(MeshSpec(data=2, spatial=2), device_type="cpu"),
                  4: make_mesh(MeshSpec(data=1, spatial=4), device_type="cpu")}
        x = _conv_input()
        for n, mesh in meshes.items():
            for case in CONVS:
                conv = _conv(*case)
                with torch.no_grad(), spatial.sharded(mesh):
                    y = conv(batch_shard(x.permute(0, 2, 3, 1), mesh).permute(0, 3, 1, 2))
                out["convs"][(n, *case)] = spatial.gather_w(y, mesh)
        model = _port_model(variables)
        out["forward", 4] = _forward(model, meshes[4])
        if rank < 2:                          # data 1 x spatial 2 on ranks 0 and 1
            pair = dist.new_group([0, 1], use_local_synchronization=True)
            mesh = make_mesh(MeshSpec(data=1, spatial=2), group=pair, device_type="cpu")
            out["forward", 2] = _forward(model, mesh)
            saved = spatial.halo_exchange
            spatial.halo_exchange = _zero_halos
            try:
                out["zero_halos"] = _forward(model, mesh)[0]
            finally:
                spatial.halo_exchange = saved
        out["full_width"] = multichip.infer_full_width(meshes[4], SMALL, SMALL_HW,
                                                       SMALL_BATCHES)
        check = multichip.infer_check(meshes[2], variables, batch=2)
        out["decode"] = {k: check[k] for k in ("dets", "failures", "objects", "collectives",
                                               "heads_rel", "mesh")}
        out["coords"] = (meshes[2].data_index, meshes[2].spatial_index)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _plain(tree):
    return {k: _plain(v) for k, v in tree.items()} if hasattr(tree, "items") \
        else np.asarray(tree)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX model and seeded variables (B0, standard layout)."""
    import jax.numpy as jnp
    from instance_segmentation_tpu.models import EfficientSeg as JaxSeg
    from instance_segmentation_tpu.models import EfficientSegConfig as JaxCfg
    from test_torch_model import random_flax_variables
    model = JaxSeg(JaxCfg(num_classes=8, compound_coef=0, backbone_s2d=False, unet_s2d=False))
    variables = random_flax_variables(model, jnp.zeros((1, H, W, 3), jnp.uint8), train=False,
                                      seed=21)
    return model, _plain(variables)


@pytest.fixture(scope="module")
def ranks(jax_case, tmp_path_factory):
    """The four ranks' results (one spawn for the module)."""
    out = tmp_path_factory.mktemp("spatial")
    multihost.spawn(_rank, WORLD, (f"file://{out}/rendezvous", jax_case[1], str(out)),
                    timeout=600)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_rank(jax_case):
    """The port's one-rank forward of ``_frames()``."""
    with torch.inference_mode():
        return [t.clone() for t in _port_model(jax_case[1])(torch.from_numpy(_frames()))]


def _jax_forward(jax_case, spatial_ranks):
    """JAX's forward of ``_frames()``, W-sharded over ``spatial_ranks``
    virtual devices as ``tests/test_spatial_sharding.py`` shards it."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from instance_segmentation_tpu.parallel.mesh import MeshSpec as JaxSpec
    from instance_segmentation_tpu.parallel.mesh import make_mesh as jax_mesh
    model, variables = jax_case
    mesh = jax_mesh(JaxSpec(data=1, spatial=spatial_ranks),
                    devices=jax.devices()[:spatial_ranks])
    xs = jax.device_put(_frames(), NamedSharding(mesh, P(None, None, "spatial", None)))
    vs = jax.device_put(variables, NamedSharding(mesh, P()))
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(vs, xs)
    return [np.asarray(o) for o in out]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("data,spatial_ranks,n", [
    (-1, 1, 8), (-1, 2, 8), (2, 4, 8), (1, 8, 8), (-1, 1, 1), (4, 1, 4),
    (-1, 3, 8), (2, 2, 8), (3, 2, 4), (-1, 0, 2), (0, 2, 4)])
def test_mesh_spec_resolves_as_jax(data, spatial_ranks, n):
    from instance_segmentation_tpu.parallel.mesh import MeshSpec as JaxSpec
    try:
        want = JaxSpec(data, spatial_ranks).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            MeshSpec(data, spatial_ranks).resolve(n)
        assert str(err.value) == str(e)
    else:
        assert MeshSpec(data, spatial_ranks).resolve(n) == want


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CONVS, ids=[f"{c[0]}{c[1]}s{c[2]}" for c in CONVS])
def test_halo_conv_matches_one_device(ranks, case, n):
    with torch.no_grad():
        want = _conv(*case)(_conv_input())
    for r in ranks:
        got = r["convs"][(n, *case)]
        if n == 2:                            # data 2 x spatial 2: the rank's image
            want_r = want[r["coords"][0]:r["coords"][0] + 1]
        assert got.shape == (want_r if n == 2 else want).shape
        assert _rel(got, want_r if n == 2 else want) <= CONV_REL, (case, n)


@pytest.mark.parametrize("case,width,match", [
    (("same", 3, 2), 36, "does not start on the stride"),
    (("same", 5, 1), 4, "exceeds the neighbour's W slab"),
    (("padded", 5, 1), 4, "exceeds the neighbour's W slab")])
def test_halo_conv_raises_naming_the_layer(case, width, match):
    """Raised before any collective, on every rank alike: a mesh record
    with no process group is enough."""
    conv = _conv(*case)
    conv.layer_name = "the_layer"
    mesh = Mesh(1, 4, 0, 0, None, None, CPU)
    x = _conv_input(width)[..., :width // 4]
    with pytest.raises(ValueError, match=f"the_layer: .*{match}"), spatial.sharded(mesh):
        conv(x)


@pytest.mark.parametrize("n", [2, 4])
def test_forward_matches_one_rank_and_jax(ranks, jax_case, one_rank, n):
    holders = ranks[:2] if n == 2 else ranks
    got, calls = holders[0]["forward", n]
    assert calls == B0_COLLECTIVES
    for r in holders[1:]:                     # every rank holds the whole outputs
        for a, b in zip(r["forward", n][0], got):
            assert torch.equal(a, b)
    want_jax = _jax_forward(jax_case, n)
    for name, g, o, j in zip(multichip.OUTPUTS, got, one_rank, want_jax):
        assert g.shape == o.shape and g.dtype == torch.float32, name
        assert _rel(g, o) <= multichip.HEADS_REL_F32, name
        np.testing.assert_allclose(g.numpy(), j, err_msg=name, **JAX_TOL)


def test_zeroed_halos_break_the_forward(ranks, one_rank):
    """Non-vacuity: with every halo zeros (the global pad at every slab
    edge), the dense heads miss the bound by more than 100x."""
    got = ranks[0]["zero_halos"]
    rel = [_rel(g, o) for g, o in zip(got[:3], one_rank[:3])]
    assert min(rel) > 100 * multichip.HEADS_REL_F32, rel


def _jax_decode(jax_case, frames):
    """JAX's forward + decode of ``frames`` on its data 2 x spatial 2 mesh, as
    ``__graft_entry__.dryrun_multichip`` runs it."""
    import jax
    import jax.numpy as jnp
    from instance_segmentation_tpu.models import generate_anchors
    from instance_segmentation_tpu.ops.decode import DecodeConfig as JaxDecode
    from instance_segmentation_tpu.ops.decode import decode_output
    from instance_segmentation_tpu.parallel.mesh import MeshSpec as JaxSpec
    from instance_segmentation_tpu.parallel.mesh import (
        batch_sharding, make_mesh as jax_mesh, replicated,
    )
    model, variables = jax_case
    cfg = model.cfg
    anchors = jnp.asarray(generate_anchors(H, W, pyramid_levels=cfg.pyramid_levels,
                                           anchor_scale=cfg.anchor_scale, scales=cfg.scales,
                                           ratios=cfg.ratios))
    c = multichip.CHECK_DECODE
    dcfg = JaxDecode(kp_th=c.kp_th, pre_nms=c.pre_nms, max_dets=c.max_dets, max_poly=c.max_poly)

    def infer_fn(v, imgs):
        return decode_output(model.apply(v, imgs, train=False), anchors, 2 * H, 2 * W, 2.0,
                             dcfg)
    mesh = jax_mesh(JaxSpec(data=2, spatial=2), devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        dets = jax.jit(infer_fn)(jax.device_put(variables, replicated(mesh)),
                                 jax.device_put(frames, batch_sharding(mesh)))
        return jax.device_get(dets)


def test_decode_2x2_matches_one_rank_and_jax(ranks, jax_case):
    by_coord = {r["coords"]: r["decode"] for r in ranks}
    for r in by_coord.values():
        assert r["failures"] == [], r["failures"]      # against the port's one-rank decode
        assert r["mesh"] == [2, 2] and r["collectives"] == B0_COLLECTIVES
    for d in (0, 1):                                    # a spatial group decodes alike
        a, b = by_coord[d, 0]["dets"], by_coord[d, 1]["dets"]
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    got = Detections(*(torch.cat(t) for t in zip(*(by_coord[d, 0]["dets"] for d in (0, 1)))))
    frames = np.random.default_rng(0).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    want = _jax_decode(jax_case, frames)
    want = Detections(*(torch.from_numpy(np.array(getattr(want, f)))
                        for f in Detections._fields))
    assert multichip.decode_differences(got, want) == []
    assert int(got.obj_valid.sum()) > 0


@pytest.mark.parametrize("what", ["train", "remat", "int8"])
def test_mesh_refuses_training_remat_and_int8(what):
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0, remat=what == "remat",
                             quant="int8" if what == "int8" else "none")
    model = EfficientSeg(cfg)
    if what == "train":
        model.train()
    mesh = Mesh(1, 2, 0, 0, None, None, CPU)
    x = torch.from_numpy(_frames())[:, :, :W // 2]
    with pytest.raises(ValueError, match="eval forward only"), spatial.sharded(mesh):
        model(x)
    assert spatial.active() is None


def test_one_rank_mesh_is_the_plain_path(jax_case):
    """Without a process group the mesh is this process alone, and a
    predictor on it answers bit for bit as one without a mesh."""
    mesh = make_mesh(MeshSpec(), device_type="cpu")
    assert (mesh.data, mesh.spatial, mesh.data_group, mesh.spatial_group) == (1, 1, None, None)
    frames = np.random.default_rng(0).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    cfg = EfficientSegConfig(num_classes=8, compound_coef=0)
    got, want = (Predictor(cfg, multichip.CHECK_DECODE, jax_case[1], CPU, (2 * H, 2 * W), 2.0,
                           mesh=m).predict(frames) for m in (mesh, None))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with spatial.sharded(mesh):
        assert spatial.active() is None


def test_batch_and_width_split():
    x = torch.arange(4 * 2 * 8 * 3).reshape(4, 2, 8, 3)
    mesh = Mesh(2, 2, 1, 1, None, None, CPU)
    assert mesh.rank == 3
    assert torch.equal(batch_shard(x, mesh), x[2:, :, 4:])
    assert torch.equal(data_shard(x, mesh), x[2:])
    with pytest.raises(ValueError, match="global batch 3 is not divisible by 2"):
        data_shard(x[:3], mesh)
    with pytest.raises(ValueError, match="image width 7 is not divisible by 2"):
        batch_shard(x[..., :7, :], mesh)


@pytest.mark.parametrize("where", ["one_rank", "four_ranks"])
def test_multichip_infer_runs_on_the_cpu_at_a_small_size(ranks, where):
    """``multichip.infer_full_width`` at B0 f32 128x256, b1 and b2: on a one-rank mesh
    in this process, and on the four ranks' data 1 x spatial 4 mesh. One
    time a call, no launch counted on the CPU, the mesh's outputs within the
    bound of the one-rank forward's and the same objects."""
    if where == "one_rank":
        results = [multichip.infer_full_width(make_mesh(MeshSpec(), device_type="cpu"),
                                              SMALL, SMALL_HW, SMALL_BATCHES)]
    else:
        results = [r["full_width"] for r in ranks]
    for r in results:
        assert r["failures"] == [] and r["device"] == "cpu"
        assert r["mesh"] == ([1, 1] if where == "one_rank" else [1, 4])
        for b, batch in zip(SMALL_BATCHES, r["batches"]):
            assert batch["batch"] == b and len(batch["ms"]) == multichip.INFER_ITERS
            assert batch["peak_bytes"] is None and batch["k1_launches"] == 0
            assert batch["objects"] == batch["objects_one_rank"]
            assert batch["collectives"] == (dict.fromkeys(B0_COLLECTIVES, 0)
                                            if where == "one_rank" else B0_COLLECTIVES)
