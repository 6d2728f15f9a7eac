"""ctypes bindings for the native mesh-preprocessing library.

JAX owns all numerics; ``native/mesh_kit.cpp`` covers the host-side
runtime in front of it — O(M) hash-based BCSR pattern construction, reverse
Cuthill-McKee ordering, and chain refinement — with a transparent numpy
fallback when the shared library cannot be built.  An incremental
``make -C native`` runs once per process, so a library older than its
source is rebuilt before it is loaded.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libmesh_kit.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if (_NATIVE_DIR / "Makefile").exists():
        # incremental: rebuilds a library older than its source
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR), "-s"],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.bcsr_pattern_count.restype = ctypes.c_int64
    lib.bcsr_pattern_count.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64]
    lib.bcsr_pattern_fill.restype = ctypes.c_int
    lib.bcsr_pattern_fill.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                      i32p, i32p, i64p, i32p, ctypes.c_int64]
    lib.rcm_ordering.restype = ctypes.c_int
    lib.rcm_ordering.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
    lib.refine_members.restype = ctypes.c_int
    lib.refine_members.argtypes = [f64p, ctypes.c_int64, i32p, ctypes.c_int64,
                                   i32p, ctypes.c_int32, f64p, i32p, i32p]
    if hasattr(lib, "aggregate_nodes"):
        lib.aggregate_nodes.restype = ctypes.c_int64
        lib.aggregate_nodes.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, i64p]
    if hasattr(lib, "rainflow_damage_sums"):
        lib.rainflow_damage_sums.restype = ctypes.c_int
        lib.rainflow_damage_sums.argtypes = [f64p, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_double,
                                             f64p, f64p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def bcsr_pattern_native(conn, n_nodes: int):
    """(block_rows, block_cols, row_ptr, elem_slot) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    m = conn.shape[0]
    nb = lib.bcsr_pattern_count(conn, m, n_nodes)
    block_rows = np.empty(nb, np.int32)
    block_cols = np.empty(nb, np.int32)
    row_ptr = np.empty(n_nodes + 1, np.int64)
    elem_slot = np.empty((m, 4), np.int32)
    rc = lib.bcsr_pattern_fill(conn, m, n_nodes, block_rows, block_cols,
                               row_ptr, elem_slot, nb)
    if rc != 0:
        raise RuntimeError("bcsr_pattern_fill failed")
    return block_rows, block_cols, row_ptr, elem_slot


def rcm_ordering(conn, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[new] = old).

    Native when available; BFS fallback in numpy/Python otherwise.
    """
    lib = _load()
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    if lib is not None:
        perm = np.empty(n_nodes, np.int32)
        rc = lib.rcm_ordering(conn, conn.shape[0], n_nodes, perm)
        if rc != 0:
            raise RuntimeError("rcm_ordering failed")
        return perm
    # Python fallback
    from collections import deque
    adj = [[] for _ in range(n_nodes)]
    for i, j in conn:
        if i != j:
            adj[i].append(int(j))
            adj[j].append(int(i))
    adj = [sorted(set(a)) for a in adj]
    visited = np.zeros(n_nodes, bool)
    order = []
    while not visited.all():
        unv = np.where(~visited)[0]
        start = min(unv, key=lambda v: len(adj[v]))
        q = deque([int(start)])
        visited[start] = True
        while q:
            v = q.popleft()
            order.append(v)
            for u in sorted((u for u in adj[v] if not visited[u]),
                            key=lambda u: len(adj[u])):
                visited[u] = True
                q.append(u)
    return np.array(order[::-1], np.int32)


def refine_members_native(coords, conn, sect, n_seg: int):
    """(new_coords, new_conn, new_sect) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    sect = np.ascontiguousarray(sect, dtype=np.int32)
    n, m = coords.shape[0], conn.shape[0]
    new_coords = np.empty((n + m * (n_seg - 1), 3), np.float64)
    new_conn = np.empty((m * n_seg, 2), np.int32)
    new_sect = np.empty(m * n_seg, np.int32)
    rc = lib.refine_members(coords, n, conn, m, sect, n_seg,
                            new_coords, new_conn, new_sect)
    if rc != 0:
        raise RuntimeError("refine_members failed")
    return new_coords, new_conn, new_sect


def aggregate_nodes_native(edges, n_nodes: int, target_size: int):
    """BFS node aggregation (the coarse-space partition) or None.

    Bit-identical to the Python reference in ``ops/coarse.py`` (tested);
    the native version exists because the traversal is pure Python
    otherwise (~1 s at 100k-DOF meshes).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "aggregate_nodes"):
        return None
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    out = np.empty(n_nodes, np.int64)
    n_agg = lib.aggregate_nodes(edges, edges.shape[0], n_nodes,
                                int(target_size), out)
    if n_agg < 0:
        raise RuntimeError("aggregate_nodes failed")
    return out


def rainflow_damage_sums_native(y, m_slope: float):
    """Batched ASTM rainflow Miner sums ``(sum w*range^m, sum w)`` per
    member, or None when the library is absent.

    ``y``: [S, M] float64 stress histories.  Matches the Python
    ``ops.spectrum._rainflow_ranges`` reduction exactly (tested); the
    native version replaces M Python stack loops (the dominant cost of
    long-history fatigue screens — measured 13x at S=4096, M=1632).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "rainflow_damage_sums"):
        return None
    y = np.ascontiguousarray(y, dtype=np.float64)
    S, M = y.shape
    out_sum = np.empty(M, np.float64)
    out_n = np.empty(M, np.float64)
    if lib.rainflow_damage_sums(y, S, M, float(m_slope), out_sum, out_n):
        raise RuntimeError("rainflow_damage_sums failed")
    return out_sum, out_n
