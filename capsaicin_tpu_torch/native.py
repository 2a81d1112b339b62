"""ctypes binding to the C++ OBJ loader (native/objloader.cpp: one pass
over the file with a hash map for the per-shape corner dedup, the
replacement of asset_load_system.cpp:40-160).

The source is compiled with the host C++ compiler ($CXX, else g++) at
first use into `_build/native-<hash of the source and flags>/`, never at
import. Where no compiler is found or the build fails, `available()` is
false and `scene.obj_loader` parses in Python. `loads` counts the files
this loader parsed, so a caller can tell which path a load took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "objloader.cpp")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libcapsaicin_native.so"
# no -march=native: the library may run on another host than it was built on
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

loads = 0  # files parsed by the C++ loader

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def compiler() -> Optional[str]:
    """The first of $CXX, g++ and c++ that is on the PATH (or a path to
    an executable); None if none is."""
    for cxx in (os.environ.get("CXX"), "g++", "c++"):
        found = cxx and shutil.which(cxx)
        if found:
            return found
    return None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}", LIB_NAME)


def build(path: Optional[str] = None) -> str:
    """Compile native/objloader.cpp into the shared library at `path`."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on the PATH")
    path = path or library_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True, capture_output=True,
                   timeout=300)
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C ABI's signatures, as capsaicin_tpu/native.py:49-69 declares them."""
    c_int, c_str, c_ptr = ctypes.c_int32, ctypes.c_char_p, ctypes.c_void_p
    lib.caps_load_obj.restype = c_ptr
    lib.caps_load_obj.argtypes = [c_str]
    lib.caps_free.argtypes = [c_ptr]
    lib.caps_num_meshes.restype = c_int
    lib.caps_num_meshes.argtypes = [c_ptr]
    lib.caps_mtllib.restype = c_str
    lib.caps_mtllib.argtypes = [c_ptr]
    for name, restype in (("caps_mesh_name", c_str), ("caps_mesh_material", c_str),
                          ("caps_mesh_vertex_count", c_int), ("caps_mesh_index_count", c_int),
                          ("caps_mesh_positions", ctypes.POINTER(ctypes.c_float)),
                          ("caps_mesh_normals", ctypes.POINTER(ctypes.c_float)),
                          ("caps_mesh_texcoords", ctypes.POINTER(ctypes.c_float)),
                          ("caps_mesh_indices", ctypes.POINTER(ctypes.c_int32))):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [c_ptr, c_int]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None if it cannot be."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                path = library_path()
                if not os.path.exists(path):
                    build(path)
                _lib = _bind(ctypes.CDLL(path))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


def load_obj_native(path: str):
    """Parse an OBJ with the C++ loader: (meshes, mtllib name), where each
    mesh is an obj_loader.MeshData with its first face's material name in
    `_material_name`; None where the library is unavailable or the file
    cannot be read."""
    global loads
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.caps_load_obj(os.fsencode(path))
    if not handle:
        return None
    from .scene.obj_loader import MeshData

    def array(ptr, n):
        return np.ctypeslib.as_array(ptr, (n,)).tolist() if n else []

    try:
        out: List[MeshData] = []
        for i in range(lib.caps_num_meshes(handle)):
            nv = lib.caps_mesh_vertex_count(handle, i)
            mesh = MeshData(
                name=lib.caps_mesh_name(handle, i).decode(),
                positions=array(lib.caps_mesh_positions(handle, i), nv * 3),
                normals=array(lib.caps_mesh_normals(handle, i), nv * 3),
                texcoords=array(lib.caps_mesh_texcoords(handle, i), nv * 2),
                indices=array(lib.caps_mesh_indices(handle, i),
                              lib.caps_mesh_index_count(handle, i)),
            )
            mesh._material_name = lib.caps_mesh_material(handle, i).decode()
            out.append(mesh)
        mtllib = lib.caps_mtllib(handle).decode()
    finally:
        lib.caps_free(handle)
    with _lock:
        loads += 1
    return out, mtllib
