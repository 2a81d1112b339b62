"""The port's OBJ/MTL/PNG ingest against the JAX package's, on the CPU:
`write_obj` gives the same bytes; `load_obj` gives the same meshes on the
Python path (exactly) and on the C++ path (indices, names and materials
exactly, floats within 1e-6: the C++ loader reads float32, the Python one
float64); `parse_mtl`, `merge_scenes` and `load_scene_obj` give the same
records and arrays. Also the fallback to the Python parser where no
compiler is found, and `load_texture`'s search and its None for a
missing or unreadable file."""

import os

import numpy as np
import pytest

from capsaicin_tpu.scene import obj_loader as jobj
from capsaicin_tpu.scene import procedural as jproc
from capsaicin_tpu.scene import scene as jscene
from capsaicin_tpu_torch import native
from capsaicin_tpu_torch.scene import obj_loader, procedural, scene, textures
from torch_threads import share_cores

share_cores()

# A hand-written OBJ: dedup of shared corners, negative (relative)
# indices, corners without texcoord or normal, a quad and a pentagon
# (fans), an empty group (dropped), a material change inside a shape (the
# first face's counts), a shape without a material, comments and a
# material file with Kd, Ke and map_Kd.
EDGE_OBJ = """# edge cases
mtllib edge.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 1 0
o quad
usemtl red
f 1/1/1 2/2/1 3/3/1 4/1/1
f 1/1/1 3/3/1 4//2
g empty
o negative
usemtl lamp
f -5/-3/-2 -4/-2/-2 -3/-1/-2
usemtl red
f -5 -3 -1
o pentagon
usemtl
f 1 2 3 5 4
"""
EDGE_MTL = """# materials
newmtl red
Kd 0.8 0.1 0.1
map_Kd red.png

newmtl lamp
Kd 0.5 0.5 0.5
Ke 4 3.5 2
"""


def _write_pair(tmp_path, port_meshes, jax_meshes, name):
    """Each package's write_obj into its own directory, same file name."""
    paths = []
    for sub, write, meshes in (("port", procedural.write_obj, port_meshes),
                               ("jax", jproc.write_obj, jax_meshes)):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        write(str(d / name), meshes)
        paths.append(d / name)
    return paths


def _meshes_equal(got, want, exact=True):
    assert [m.name for m in got] == [m.name for m in want]
    for a, b in zip(got, want):
        assert a.indices == b.indices, a.name
        assert a.texture_name == b.texture_name, a.name
        assert a.material == b.material or (a.material.__dict__ == b.material.__dict__), a.name
        for f in ("positions", "normals", "texcoords"):
            if exact:
                assert getattr(a, f) == getattr(b, f), (a.name, f)
            else:
                np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=1e-6,
                                           err_msg=f"{a.name} {f}")


SCENES = {
    "cornell": (procedural.cornell_box, jproc.cornell_box),
    "colonnade": (lambda: procedural.colonnade(target_tris=2000),
                  lambda: jproc.colonnade(target_tris=2000)),
}


@pytest.mark.parametrize("which", list(SCENES))
def test_write_obj_bytes_match_jax(tmp_path, which):
    port, jax = SCENES[which]
    a, b = _write_pair(tmp_path, port(), jax(), "scene.obj")
    assert a.read_bytes() == b.read_bytes()
    assert a.with_suffix(".mtl").read_bytes() == b.with_suffix(".mtl").read_bytes()


@pytest.mark.parametrize("path", ["python", "native"])
@pytest.mark.parametrize("which", list(SCENES))
def test_load_obj_matches_jax(tmp_path, monkeypatch, which, path):
    """Both of the port's paths against the JAX package's Python parser."""
    port, _ = SCENES[which]
    obj = str(tmp_path / "scene.obj")
    procedural.write_obj(obj, port())
    want, want_mats = jobj.load_obj(obj, force_python=True)
    if path == "native":
        assert native.available()
        monkeypatch.setattr(obj_loader, "NATIVE_SIZE_THRESHOLD", 0)
        loads = native.loads
        got, mats = obj_loader.load_obj(obj)
        assert native.loads == loads + 1  # the C++ loader took the file
    else:
        got, mats = obj_loader.load_obj(obj, force_python=True)
    _meshes_equal(got, want, exact=path == "python")
    assert {k: v.__dict__ for k, v in mats.items()} == {k: v.__dict__ for k, v in
                                                         want_mats.items()}


def test_edge_cases_match_jax(tmp_path, monkeypatch):
    (tmp_path / "edge.obj").write_text(EDGE_OBJ)
    (tmp_path / "edge.mtl").write_text(EDGE_MTL)
    obj = str(tmp_path / "edge.obj")
    want, want_mats = jobj.load_obj(obj, force_python=True)
    got, mats = obj_loader.load_obj(obj, force_python=True)
    _meshes_equal(got, want)
    monkeypatch.setattr(obj_loader, "NATIVE_SIZE_THRESHOLD", 0)
    nat, _ = obj_loader.load_obj(obj)
    _meshes_equal(nat, want, exact=False)
    assert [m.name for m in got] == ["quad", "negative", "pentagon"]  # "empty" dropped
    quad, neg, pent = got
    # 6 corners of 2 fan triangles, 4 distinct; 4//2 is another corner
    assert quad.indices == [0, 1, 2, 0, 2, 3, 0, 2, 4] and len(quad.positions) == 15
    assert quad.normals[12:15] == [0.0, 1.0, 0.0] and quad.texcoords[8:10] == [0.0, 0.0]
    assert quad.texture_name == "red.png" and quad.material.kd == (0.8, 0.1, 0.1)
    # -5 of 5 positions is the first; the first face's material counts
    assert neg.positions[:3] == [0.0, 0.0, 0.0] and neg.material.name == "lamp"
    assert neg.material.ke == (4.0, 3.5, 2.0) and neg.texture_name == ""
    # -2 of 2 normals is the first; the second face has none
    assert neg.normals[:3] == [0.0, 0.0, 1.0] and neg.normals[9:12] == [0.0, 0.0, 0.0]
    assert pent.material is None and len(pent.indices) == 9
    assert pent.indices == [0, 1, 2, 0, 2, 3, 0, 3, 4]
    assert {k: v.__dict__ for k, v in mats.items()} == {k: v.__dict__ for k, v in
                                                         want_mats.items()}


def test_parse_mtl_matches_jax(tmp_path):
    (tmp_path / "a.mtl").write_text(EDGE_MTL + "Kd 1 1 1\nnewmtl\nmap_Kd -s 1 1 1 t.png\n")
    got = obj_loader.parse_mtl(str(tmp_path / "a.mtl"))
    want = jobj.parse_mtl(str(tmp_path / "a.mtl"))
    assert {k: v.__dict__ for k, v in got.items()} == {k: v.__dict__ for k, v in want.items()}
    assert got[""].diffuse_texname == "t.png"
    assert obj_loader.parse_mtl(str(tmp_path / "missing.mtl")) == {}


def test_python_fallback_without_a_compiler(tmp_path, monkeypatch):
    """No compiler: available() is false, load_obj parses in Python and
    the C++ loader's count does not move."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "lib" / "x.so"))
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.compiler() is None and not native.available()
    monkeypatch.setattr(obj_loader, "NATIVE_SIZE_THRESHOLD", 0)
    obj = str(tmp_path / "cb.obj")
    procedural.write_obj(obj, procedural.cornell_box())
    loads = native.loads
    got, _ = obj_loader.load_obj(obj)
    assert native.loads == loads
    _meshes_equal(got, jobj.load_obj(obj, force_python=True)[0])


def _jax_pair(kind):
    """(port Scene, JAX Scene) of one procedural scene, built by each package."""
    if kind == "plain":
        return scene.build_scene(procedural.cornell_box()), jscene.build_scene(jproc.cornell_box())
    if kind == "textured":
        return (scene.build_scene(*procedural.cornell_box_textured()),
                jscene.build_scene(*jproc.cornell_box_textured()))
    return (scene.build_scene(*procedural.cornell_box_multitextured()),
            jscene.build_scene(*jproc.cornell_box_multitextured()))


def _scenes_equal(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if b.dtype == np.uint32:  # the port holds the rgba8 atlas as int32 of the same bits
            a = a.view(np.uint32)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("first, second, u32", [
    ("plain", "textured", False), ("textured", "plain", False),
    ("textured", "multi", False), ("multi", "textured", False),
    ("textured", "multi", True), ("plain", "plain", False)])
def test_merge_scenes_matches_jax(first, second, u32):
    """Offsets, texture ids shifted past the first atlas, atlases re-padded
    to the joint tile, and a placeholder atlas dropped; also the rgba8
    atlas."""
    (a, ja), (b, jb) = _jax_pair(first), _jax_pair(second)
    if u32:
        a, b = scene.quantize_atlas(a), scene.quantize_atlas(b)
        ja, jb = jscene.quantize_atlas(ja), jscene.quantize_atlas(jb)
    merged = scene.merge_scenes(a, b)
    _scenes_equal(merged, jscene.merge_scenes(ja, jb))
    assert merged.num_meshes == a.num_meshes + b.num_meshes


def test_merge_scenes_equals_one_build():
    a, b = procedural.cornell_box(), procedural.colonnade(target_tris=200)
    merged = scene.merge_scenes(scene.build_scene(a), scene.build_scene(b))
    _scenes_equal(merged, scene.build_scene(a + b))
    with pytest.raises(ValueError):  # the two atlas forms do not mix
        t = scene.build_scene(*procedural.cornell_box_textured())
        scene.merge_scenes(t, scene.quantize_atlas(t))


def _save_png(path, img):
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8), "RGBA").save(path)


def test_load_scene_obj_matches_jax(tmp_path):
    """The textured colonnade written as OBJ + MTL + two PNGs: the same
    Scene from both packages, with both textures in the atlas (2 entries,
    128x128 tiles, a 48x96 stripe); a texture that is missing becomes the
    1x1 zero texture in both."""
    meshes, images = procedural.colonnade_textured(target_tris=2000)
    obj = str(tmp_path / "col.obj")
    procedural.write_obj(obj, meshes)
    for name, img in images.items():
        _save_png(str(tmp_path / name), img)
    got = scene.load_scene_obj(obj, texture_dir=str(tmp_path))
    _scenes_equal(got, jscene.load_scene_obj(obj, texture_dir=str(tmp_path)))
    assert got.atlas.shape == (2, 128, 128, 16)
    assert sorted(got.atlas_size.tolist()) == [[96, 48], [128, 128]]
    assert sorted(set(got.mesh_texture.tolist())) == [-1, 0, 1]
    # the PNGs hold the procedural textures exactly (8-bit grid), so the
    # atlas is the one built from the images in memory
    np.testing.assert_array_equal(got.atlas, scene.build_scene(meshes, images).atlas)
    os.remove(tmp_path / "stripes.png")
    missing = scene.load_scene_obj(obj, texture_dir=str(tmp_path))
    _scenes_equal(missing, jscene.load_scene_obj(obj, texture_dir=str(tmp_path)))
    assert missing.atlas_size.tolist() == [[128, 128], [1, 1]]


def test_colonnade_textured_matches_jax():
    meshes, images = procedural.colonnade_textured(target_tris=2000)
    jmeshes, jimages = jproc.colonnade_textured(target_tris=2000)
    _meshes_equal(meshes, jmeshes)
    assert images.keys() == jimages.keys()
    for k in images:
        np.testing.assert_array_equal(images[k], jimages[k])


def test_load_texture_search_and_failures(tmp_path, monkeypatch):
    img = procedural.checker_texture(size=8, tiles=2)
    _save_png(str(tmp_path / "t.png"), img)
    np.testing.assert_array_equal(textures.load_texture("t.png", str(tmp_path)), img)
    assert textures.load_texture("t.png") is None  # not on the search path
    monkeypatch.chdir(tmp_path)  # the working directory is searched last
    np.testing.assert_array_equal(textures.load_texture("t.png"), img)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    assert textures.load_texture("bad.png", str(tmp_path)) is None
    assert textures.load_texture("none.png", str(tmp_path)) is None
    assert textures.asset_dir() == jproc.__file__.rsplit("capsaicin_tpu", 1)[0] + "assets"
