"""The port's loaders, native library, Mitsuba XML loader, command-line
renderer and tools (gvpm_tpu_torch/utils/{exr,volume,meshio}.py,
native/, scene/mitsuba.py, cli.py, tools/{goldens,compare}.py) against
the JAX package's, all without a large JAX compile.

- File readers: EXR, .vol, OBJ, PLY (ascii and binary) and Mitsuba
  .serialized files written here read to equal arrays through both
  packages; the port writes byte-identical EXR and .vol files.
- Native library: OBJ loader, BVH build and Morton order equal the JAX
  package's (tests/test_native.py's inputs).
- Mitsuba loader: tests/test_mitsuba_loader.py's XML, and one with mesh,
  heterogeneous-medium, environment-map and delta-light files, load to
  scene tables equal to the JAX loader's, with the same meta.
- CLI: every -i choice at 8x8 on the CPU writes the five outputs with a
  finite image (pssmlt / mlt / erpt with their default 4096 chains take
  most of this file's time); -i bdpt equals bdpt.render; the checkpoint
  round trip of tests/test_cli.py; --time-max writes the passes so far;
  without a card and without --device (device=) the CLI and
  mitsuba.load raise; --mesh 2 on the CPU (two gloo ranks) renders the
  JAX CLI's --mesh 2 image, and --mesh 3 on 16 rows fails.
- Tools: compare.py runs at 8x8 on a pass budget; goldens.py plans its
  checks from each meta.json's recorded thresholds (its renders run on
  the card in chip_smoke.py's [cli]).
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from gvpm_tpu import cli as jcli
from gvpm_tpu.native import bind as jbind
from gvpm_tpu.scene import mitsuba as jmitsuba
from gvpm_tpu.utils import exr as jexr
from gvpm_tpu.utils import meshio as jmeshio
from gvpm_tpu.utils import volume as jvolume
from gvpm_tpu_torch import cli, scenes
from gvpm_tpu_torch.core.config import PhotonConfig, VolPathConfig
from gvpm_tpu_torch.integrators import bdpt
from gvpm_tpu_torch.native import bind
from gvpm_tpu_torch.parallel import dist
from gvpm_tpu_torch.parallel.launch import RankError, launch
from gvpm_tpu_torch.scene import mitsuba
from gvpm_tpu_torch.tools import compare, goldens
from gvpm_tpu_torch.utils import exr, meshio, volume
from gvpm_tpu_torch.utils import image as imglib
from tests.test_mitsuba_loader import XML
from tests.test_native import OBJ
from tests.test_torch_common import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = (".pfm", ".exr", ".png", "_time.csv", "_meta.json")
SMALL = ["--spp", "1", "--passes", "1", "--photons", "1024",
         "--max-depth", "3", "--width", "8", "--height", "8"]

PLY_ASCII = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
property float nx
property float ny
property float nz
element face 2
property list uchar int vertex_indices
end_header
0 0 0 0 0 1
1 0 0 0 0 1
1 1 0 0 0 1
0 1 0 0 0 1
3 0 1 2
4 0 1 2 3
"""


def _ply_binary(path, v, faces):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n"
                b"element vertex %d\nproperty float x\nproperty float y\n"
                b"property float z\nelement face %d\n"
                b"property list uchar int vertex_indices\nend_header\n"
                % (len(v), len(faces)))
        f.write(np.asarray(v, "<f4").tobytes())
        for face in faces:
            f.write(struct.pack("<B", len(face)))
            f.write(struct.pack("<%di" % len(face), *face))


def _serialized(path, shapes):
    """A Mitsuba .serialized file (format version 4) of [(v, faces)]:
    per shape its header and zlib stream (float32 vertices with normals,
    uint32 faces), then the offset table and the shape count."""
    blobs = []
    for v, faces in shapes:
        v = np.asarray(v, np.float32)
        body = struct.pack("<I", 0x0001 | 0x1000) + b"mesh\x00" \
            + struct.pack("<QQ", len(v), len(faces)) + v.tobytes() \
            + np.ones_like(v).tobytes() \
            + np.asarray(faces, np.uint32).tobytes()
        blobs.append(struct.pack("<HH", 0x041C, 4) + zlib.compress(body))
    offsets, pos = [], 0
    for b in blobs:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(b"".join(blobs))
        f.write(struct.pack("<%dQ" % len(offsets), *offsets))
        f.write(struct.pack("<I", len(blobs)))


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exr_and_vol_read_and_write_as_the_jax_package(tmp_path):
    rs = np.random.default_rng(0)
    img = rs.normal(size=(5, 7, 3)).astype(np.float32)
    dens = rs.random((3, 4, 5)).astype(np.float32)
    for mod, tag in ((exr, "port"), (jexr, "jax")):
        mod.write_exr(str(tmp_path / f"{tag}.exr"), img)
    for mod, tag in ((volume, "port"), (jvolume, "jax")):
        mod.write_vol(str(tmp_path / f"{tag}.vol"), dens, [0, 0, 0],
                      [1, 2, 3])
    for ext in ("exr", "vol"):
        assert (tmp_path / f"port.{ext}").read_bytes() \
            == (tmp_path / f"jax.{ext}").read_bytes(), ext
    _same(exr.read_exr(str(tmp_path / "jax.exr")), img)
    _same(exr.read_exr(str(tmp_path / "jax.exr")),
          jexr.read_exr(str(tmp_path / "port.exr")))
    for a, b in zip(volume.read_vol(str(tmp_path / "jax.vol")),
                    jvolume.read_vol(str(tmp_path / "port.vol"))):
        _same(a, b)
    _same(volume.read_vol(str(tmp_path / "port.vol"))[0], dens)


def test_mesh_files_read_as_the_jax_package(tmp_path):
    (tmp_path / "m.obj").write_text(OBJ)
    (tmp_path / "a.ply").write_text(PLY_ASCII)
    rs = np.random.default_rng(1)
    v = rs.random((6, 3)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5]]
    _ply_binary(str(tmp_path / "b.ply"), v, faces)
    _serialized(str(tmp_path / "m.serialized"),
                [(v, [[0, 1, 2], [3, 4, 5]]), (v[:3] * 2, [[2, 1, 0]])])
    for fn in ("m.obj",):
        for a, b in zip(meshio.load_obj(str(tmp_path / fn)),
                        jmeshio.load_obj(str(tmp_path / fn))):
            _same(a, b)
    for fn in ("a.ply", "b.ply"):
        got = meshio.load_ply(str(tmp_path / fn))
        for a, b in zip(got, jmeshio.load_ply(str(tmp_path / fn))):
            _same(a, b)
        assert got[1].shape == (3, 3)
    for i in (0, 1):
        got = meshio.load_serialized(str(tmp_path / "m.serialized"), i)
        for a, b in zip(got, jmeshio.load_serialized(
                str(tmp_path / "m.serialized"), i)):
            _same(a, b)
    _same(got[0], v[:3] * 2)


def test_native_library_as_the_jax_package(tmp_path):
    """The port's host_ops.cpp, built by g++ into gvpm_tpu_torch/_build,
    against the JAX package's build: OBJ parse, BVH, Morton order."""
    assert bind.library_path().startswith(bind.BUILD_DIR)
    (tmp_path / "m.obj").write_text(OBJ)
    for a, b in zip(bind.load_obj(str(tmp_path / "m.obj")),
                    jbind.load_obj(str(tmp_path / "m.obj"))):
        _same(a, b)
    rs = np.random.default_rng(0)
    c = rs.uniform(0, 10, (500, 3)).astype(np.float32)
    h = rs.uniform(0.01, 0.2, (500, 1)).astype(np.float32)
    got, want = bind.build_bvh(c - h, c + h), jbind.build_bvh(c - h, c + h)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])
    pts = rs.uniform(0, 1, (2048, 3)).astype(np.float32)
    _same(bind.morton_order(pts, np.zeros(3), np.ones(3)),
          jbind.morton_order(pts, np.zeros(3), np.ones(3)))


FILES_XML = """<?xml version="1.0"?>
<scene version="0.5.0">
    <default name="res" value="24"/>
    <sensor type="thinlens">
        <float name="fov" value="40"/>
        <float name="apertureRadius" value="0.02"/>
        <float name="focusDistance" value="1.5"/>
        <transform name="toWorld">
            <lookat origin="0.5, 0.5, -1.2" target="0.5, 0.5, 0.5"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="$res"/>
            <integer name="height" value="16"/>
        </film>
    </sensor>
    <medium type="heterogeneous" id="smoke">
        <float name="scale" value="2"/>
        <rgb name="albedo" value="0.8, 0.7, 0.6"/>
        <volume type="gridvolume" name="density">
            <string name="filename" value="d.vol"/>
        </volume>
    </medium>
    <shape type="obj">
        <string name="filename" value="m.obj"/>
        <transform name="toWorld"><scale value="0.5"/></transform>
        <bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf>
    </shape>
    <shape type="ply">
        <string name="filename" value="a.ply"/>
        <transform name="toWorld"><translate x="0.2"/></transform>
        <bsdf type="plastic"/>
    </shape>
    <shape type="serialized">
        <string name="filename" value="m.serialized"/>
        <integer name="shapeIndex" value="1"/>
        <bsdf type="phong"/>
    </shape>
    <shape type="cube">
        <transform name="toWorld">
            <scale value="0.3"/><translate x="0.5" y="0.5" z="0.5"/>
        </transform>
        <ref name="interior" id="smoke"/>
    </shape>
    <shape type="disk">
        <transform name="toWorld"><translate y="0.9"/></transform>
        <emitter type="area"><rgb name="radiance" value="4, 5, 6"/></emitter>
    </shape>
    <emitter type="point">
        <point name="position" value="0.5, 0.8, 0.2"/>
        <spectrum name="intensity" value="3"/>
    </emitter>
    <emitter type="spot">
        <transform name="toWorld">
            <lookat origin="0.1, 0.9, 0.1" target="0.5, 0, 0.5"/>
        </transform>
        <float name="cutoffAngle" value="25"/>
    </emitter>
    <emitter type="envmap">
        <string name="filename" value="env.exr"/>
        <float name="scale" value="0.5"/>
    </emitter>
</scene>
"""


def _scene_files(d):
    (d / "m.obj").write_text(OBJ)
    (d / "a.ply").write_text(PLY_ASCII)
    rs = np.random.default_rng(5)
    v = rs.random((6, 3)).astype(np.float32)
    _serialized(str(d / "m.serialized"),
                [(v, [[0, 1, 2]]), (v, [[0, 1, 2], [3, 4, 5]])])
    jvolume.write_vol(str(d / "d.vol"), rs.random((4, 3, 2)).astype(
        np.float32), [0.35, 0.35, 0.35], [0.65, 0.65, 0.65])
    jexr.write_exr(str(d / "env.exr"), rs.random((8, 16, 3)).astype(
        np.float32))


@pytest.mark.parametrize("xml", ("loader_test", "files"))
def test_mitsuba_loader_matches_jax(tmp_path, xml):
    """The XML of tests/test_mitsuba_loader.py (with its -D override),
    and one that reads every file format, load to the JAX loader's
    tables value for value and to the same meta."""
    path = tmp_path / "scene.xml"
    if xml == "files":
        _scene_files(tmp_path)
        path.write_text(FILES_XML)
        defaults = {"res": 20}
    else:
        path.write_text(XML)
        defaults = {"photons": 5000}
    js, jmeta = jmitsuba.load(str(path), defaults=defaults)
    ts, meta = mitsuba.load(str(path), defaults=defaults, device="cpu")
    assert meta == jmeta
    for k, v in ts.tensors().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(js, k)),
                                      err_msg=k)
    for k in ("width", "height", "cam_aperture", "cam_focus",
              "het_medium"):
        assert getattr(ts, k) == getattr(js, k), k
    if xml == "files":
        assert ts.width == 20 and ts.het_medium >= 0
        assert ts.cam_aperture > 0 and ts.env_map.shape[0] == 8


def _run(tmp_path, name, *extra):
    dest = str(tmp_path / name)
    assert cli.main(["box-medium", *SMALL, "--device", "cpu", "-o", dest,
                     *extra]) == 0
    return dest


# the chain integrators first: they take most of the file's time
@pytest.mark.parametrize("integrator", ("pssmlt", "mlt", "erpt") + tuple(
    i for i in cli.INTEGRATORS if i not in ("pssmlt", "mlt", "erpt")))
def test_cli_renders_every_integrator(tmp_path, integrator):
    dest = _run(tmp_path, "out", "-i", integrator)
    for ext in OUTPUTS:
        assert os.path.exists(dest + ext), ext
    img = imglib.read_pfm(dest + ".pfm")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    with open(dest + "_meta.json") as f:
        meta = json.load(f)
    assert meta["integrator"] == integrator and meta["device"] == "cpu"
    if integrator in ("gbdpt", "gvpm", "gpt"):
        for extra in ("primal", "gx", "gy"):
            assert np.isfinite(imglib.read_pfm(f"{dest}_{extra}.pfm")).all()
    if integrator == "bdpt":
        want = bdpt.render(scenes.box_medium(8, 8, device="cpu"),
                           VolPathConfig(spp=1, max_depth=3), seed=0)
        np.testing.assert_array_equal(img, want.numpy())


def test_cli_checkpoint_resume(tmp_path):
    """tests/test_cli.py's round trip through the port's CLI: a run
    stopped after 2 passes (checkpoint every 2) resumes to 4 and matches
    an uninterrupted 4-pass run."""
    kw = ["-i", "sppm", "--photons", "2048", "--max-depth", "4"]
    full = _run(tmp_path, "full", *kw, "--passes", "4")
    ck = str(tmp_path / "state.npz")
    _run(tmp_path, "half", *kw, "--passes", "2", "--checkpoint", ck,
         "--checkpoint-every", "2")
    assert os.path.exists(ck)
    resumed = _run(tmp_path, "resumed", *kw, "--passes", "4",
                   "--checkpoint", ck, "--checkpoint-every", "2")
    np.testing.assert_allclose(imglib.read_pfm(resumed + ".pfm"),
                               imglib.read_pfm(full + ".pfm"), rtol=1e-5,
                               atol=1e-7)
    # the resumed run timed only the passes it ran
    with open(resumed + "_time.csv") as f:
        assert len(f.read().splitlines()) == 2


def test_cli_time_max_writes_the_passes_so_far(tmp_path):
    dest = _run(tmp_path, "t", "-i", "sppm", "--passes", "5",
                "--time-max", "1e-6")
    with open(dest + "_time.csv") as f:
        assert len(f.read().splitlines()) == 1
    img = imglib.read_pfm(dest + ".pfm")
    assert np.isfinite(img).all() and img.mean() > 0


def test_cli_and_loader_refusals(tmp_path):
    path = tmp_path / "scene.xml"
    path.write_text(XML)
    if torch.cuda.is_available():
        return
    for call in (lambda: cli.main(["box-medium", *SMALL,
                                   "-o", str(tmp_path / "x")]),
                 lambda: mitsuba.load(str(path))):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()


# 256 paths: no query's stencil exceeds the CLI's per-cell budget (2 x 32
# rows), so no overflow subsample turns last-bit radius differences into
# other photons (ROADMAP.md section 3); at 1024 paths it does
MESH_ARGS = ["box-medium", "-i", "sppm", "--photons", "256", "--passes",
             "2", "--max-depth", "3", "--width", "16", "--height", "16"]


def test_cli_mesh_renders_as_the_jax_cli(tmp_path):
    """--mesh 2 on the CPU: two gloo ranks run parallel.dist.render, and
    rank 0 writes the outputs; the image equals the JAX CLI's --mesh 2 at
    the pass bar and the port's dist.render launched directly bit for
    bit. --mesh 3 does not split the 16 rows and fails its ranks."""
    dest = str(tmp_path / "port")
    assert cli.main(MESH_ARGS + ["--mesh", "2", "--device", "cpu", "-o",
                                 dest]) == 0
    for ext in OUTPUTS:
        assert os.path.exists(dest + ext), ext
    got = imglib.read_pfm(dest + ".pfm")
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    assert got.mean() > 0
    jdest = str(tmp_path / "jax")
    assert jcli.main(MESH_ARGS + ["--mesh", "2", "-o", jdest]) == 0
    np.testing.assert_allclose(got, imglib.read_pfm(jdest + ".pfm"),
                               rtol=2e-4, atol=5e-6)
    cfg = PhotonConfig(max_depth=3, surface_photons=256,
                       volume_photons=256, max_passes=2)
    direct = launch(2, dist.render, scenes.box_medium(16, 16, device="cpu"),
                    cfg, volume="distance", seed=0, passes=2, device="cpu",
                    timeout=300)
    np.testing.assert_array_equal(got, direct["image"].numpy())
    with pytest.raises(RankError, match="H % n"):
        cli.main(MESH_ARGS + ["--mesh", "3", "--device", "cpu", "-o",
                              str(tmp_path / "three")])


def test_compare_runs_on_a_pass_budget(tmp_path):
    out = str(tmp_path / "res")
    assert compare.main(["--width", "8", "--height", "8", "--ref-seconds",
                         "0", "--passes", "2", "--photons", "1024",
                         "--device", "cpu", "--techniques", "volpath", "gpt",
                         "sppm:distance", "gvpm:distance", "-o", out]) == 0
    with open(os.path.join(out, "box-medium_summary.json")) as f:
        rows = json.load(f)
    assert [r["technique"] for r in rows] == [
        "volpath", "gpt", "sppm:distance", "gvpm:distance"]
    assert [r["passes"] for r in rows] == [0, 2, 2, 2]
    assert all(np.isfinite(r["relmse"]) for r in rows)


@pytest.mark.parametrize("sub", ("ci", "."))
def test_goldens_plans_the_recorded_thresholds(sub):
    gdir = os.path.join(ROOT, "goldens", sub)
    with open(os.path.join(gdir, "meta.json")) as f:
        meta = json.load(f)
    got = goldens.plan(meta)
    want = [(name, tech, 30 if tech.endswith("plane0d") else 10, bar)
            for name, s in meta["scenes"].items()
            for tech, bar in s["thresholds"].items()]
    assert got == want and len(got) >= 9
    # the JAX tool's default list asks for techniques this artifact does
    # not record (tools/goldens.py:60-66, 230); the port's plan does not
    assert all(t in meta["scenes"][n]["thresholds"] for n, t, _, _ in got)
    assert goldens.plan(meta, scenes=("box-medium", "nowhere")) == [
        c for c in want if c[0] == "box-medium"]
    if sub == ".":
        assert ("box-medium", "gvpm:bre") not in {c[:2] for c in got}
        assert ("box-medium", "sppm:plane0d", 30) in {c[:3] for c in got}
