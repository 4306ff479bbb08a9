"""Host-side native code, built on demand with g++ and bound with ctypes
(port of wire_tpu/native/__init__.py:27-167 for the marching cubes):

- ``marching_cubes(volume, iso)``: the iso-surface of a float volume
  (``marching_cubes.cpp``, a copy of wire_tpu's);
- ``export_mesh``, ``export_obj``, ``export_dae``: plain-Python mesh
  writers (.obj and a minimal COLLADA .dae).

The library is compiled at first use into ``wire_tpu_torch/_build/``
under a name that carries a hash of the source and the flags, written to a
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
_SOURCE = os.path.join(_HERE, "marching_cubes.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _compile():
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + f.read())
    so = os.path.join(_BUILD, f"marching_cubes-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for marching_cubes.cpp "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(_compile())
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
