"""Host-side native code, built on demand with g++ and bound with ctypes
(port of wire_tpu/native/__init__.py:27-167):

- ``marching_cubes(volume, iso)``: the iso-surface of a float volume
  (``marching_cubes.cpp``, a copy of wire_tpu's);
- ``rigid_register(ref, moving, ...)``: Gauss-Newton rigid registration of
  two frames (``registration.cpp``, a copy of wire_tpu's);
- ``export_mesh``, ``export_obj``, ``export_dae``: plain-Python mesh
  writers (.obj and a minimal COLLADA .dae).

Each source is compiled at first use into its own library in
``wire_tpu_torch/_build/``, under a name that carries a hash of the source
and the flags (wire_tpu's: ``-O3 -march=native -std=c++17``), written to a
temporary name and renamed into place.  This is host code: nothing here
runs on the GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _compile(name):
    """The path of ``<name>.cpp``'s library, built if it is not there."""
    source = os.path.join(_HERE, f"{name}.cpp")
    with open(source, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + f.read())
    so = os.path.join(_BUILD, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cpp "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_compile("marching_cubes"))
    lib.mc_run.restype = ctypes.c_int
    lib.mc_run.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_long)]
    lib.mc_free.argtypes = [ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int)]
    return lib


def marching_cubes(volume, iso):
    """The iso-surface of a (nx, ny, nz) float volume: (vertices (n, 3)
    float32 in voxel coordinates, faces (m, 3) int32)."""
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    nx, ny, nz = vol.shape
    lib = _lib()
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int)()
    nverts = ctypes.c_long()
    ntris = ctypes.c_long()
    rc = lib.mc_run(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    nx, ny, nz, ctypes.c_float(iso),
                    ctypes.byref(verts_p), ctypes.byref(nverts),
                    ctypes.byref(tris_p), ctypes.byref(ntris))
    if rc != 0:
        raise RuntimeError(f"mc_run failed with code {rc}")
    nv, nt = nverts.value, ntris.value
    verts = (np.ctypeslib.as_array(verts_p, shape=(nv, 3)).copy() if nv
             else np.zeros((0, 3), np.float32))
    faces = (np.ctypeslib.as_array(tris_p, shape=(nt, 3)).copy() if nt
             else np.zeros((0, 3), np.int32))
    lib.mc_free(verts_p, tris_p)
    return verts, faces


@functools.lru_cache(maxsize=None)
def _registration_lib():
    lib = ctypes.CDLL(_compile("registration"))
    lib.rigid_register.restype = ctypes.c_int
    lib.rigid_register.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float)]
    return lib


def rigid_register(ref, moving, max_iters=100, eps=1e-6, init_warp=None):
    """The 2 x 3 Euclidean warp W aligning ``moving`` onto ``ref``
    (moving(W [x y 1]^T) ~ ref(x, y)), refined from ``init_warp`` (the
    identity by default) by Gauss-Newton; raises on singular normal
    equations."""
    ref = np.ascontiguousarray(ref, np.float32)
    moving = np.ascontiguousarray(moving, np.float32)
    if ref.shape != moving.shape or ref.ndim != 2:
        raise ValueError(f"rigid_register: two 2-D frames of one shape, got "
                         f"{ref.shape} and {moving.shape}")
    h, w = ref.shape
    warp = (np.eye(2, 3, dtype=np.float32) if init_warp is None
            else np.array(init_warp, np.float32, order="C"))
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = _registration_lib().rigid_register(
        ref.ctypes.data_as(f32p), moving.ctypes.data_as(f32p), h, w,
        max_iters, ctypes.c_float(eps), warp.ctypes.data_as(f32p))
    if rc != 0:
        raise RuntimeError("rigid_register: singular normal equations")
    return warp


def export_mesh(vertices, faces, path):
    """Write the mesh as .obj or .dae, by the path's suffix."""
    if path.endswith(".obj"):
        export_obj(vertices, faces, path)
    elif path.endswith(".dae"):
        export_dae(vertices, faces, path)
    else:
        raise ValueError(f"unsupported mesh format: {path}")


def export_obj(vertices, faces, path):
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def export_dae(vertices, faces, path):
    """A minimal COLLADA 1.4 document with one triangle mesh."""
    pos = " ".join(f"{x:g}" for x in np.asarray(vertices).ravel())
    idx = " ".join(str(i) for i in np.asarray(faces).ravel())
    nv = len(vertices)
    nt = len(faces)
    doc = f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Z_UP</up_axis></asset>
  <library_geometries>
    <geometry id="mesh" name="mesh">
      <mesh>
        <source id="positions">
          <float_array id="positions-array" count="{nv * 3}">{pos}</float_array>
          <technique_common>
            <accessor source="#positions-array" count="{nv}" stride="3">
              <param name="X" type="float"/><param name="Y" type="float"/><param name="Z" type="float"/>
            </accessor>
          </technique_common>
        </source>
        <vertices id="verts"><input semantic="POSITION" source="#positions"/></vertices>
        <triangles count="{nt}">
          <input semantic="VERTEX" source="#verts" offset="0"/>
          <p>{idx}</p>
        </triangles>
      </mesh>
    </geometry>
  </library_geometries>
  <library_visual_scenes>
    <visual_scene id="scene">
      <node id="node"><instance_geometry url="#mesh"/></node>
    </visual_scene>
  </library_visual_scenes>
  <scene><instance_visual_scene url="#scene"/></scene>
</COLLADA>
"""
    with open(path, "w") as f:
        f.write(doc)
