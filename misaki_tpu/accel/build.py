"""BVH2 builder — host-side NumPy, binned SAH with median fallback.

This replaces Embree's build step (reference scene.cpp:197-212,
rtcCommitScene). Build time is not the benchmark metric (SURVEY.md section 7
step 3); traversal happens on-device in accel/traverse.py.

Output layout (flat SoA, types.BVH):
  * internal node: node_left/right = child indices, is_leaf = False
  * leaf: node_left = first index into prim_order, node_right = prim count
Children are stored so that traversal can pick the near child first.

Small scenes (<= BRUTE_FORCE_THRESHOLD faces) get an empty BVH: the
traverser then uses an all-faces brute-force intersection loop, which beats
pointer chasing for tiny scenes (pure elementwise streaming).
"""

import numpy as np

from misaki_tpu.scene.types import BVH

BRUTE_FORCE_THRESHOLD = 320
LEAF_SIZE = 4
N_BINS = 16


def build_bvh(p0, e1, e2, leaf_size=LEAF_SIZE, force=False, force_brute=False):
    F = len(p0)
    if (F <= BRUTE_FORCE_THRESHOLD or force_brute) and not force:
        return BVH(
            node_lo=np.zeros((0, 3), np.float32),
            node_hi=np.zeros((0, 3), np.float32),
            node_left=np.zeros(0, np.int32),
            node_right=np.zeros(0, np.int32),
            node_is_leaf=np.zeros(0, bool),
            prim_order=np.arange(F, dtype=np.int32),
        )

    v0 = np.asarray(p0, np.float64)
    v1 = v0 + e1
    v2 = v0 + e2
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tri_lo + tri_hi)

    node_lo, node_hi = [], []
    node_left, node_right, node_is_leaf = [], [], []
    prim_order = []

    def new_node():
        node_lo.append(None)
        node_hi.append(None)
        node_left.append(0)
        node_right.append(0)
        node_is_leaf.append(False)
        return len(node_lo) - 1

    root = new_node()
    # worklist of (node_idx, prim index array)
    stack = [(root, np.arange(F))]
    while stack:
        node, prims = stack.pop()
        lo = tri_lo[prims].min(axis=0)
        hi = tri_hi[prims].max(axis=0)
        node_lo[node] = lo
        node_hi[node] = hi
        n = len(prims)
        if n <= leaf_size:
            node_is_leaf[node] = True
            node_left[node] = len(prim_order)
            node_right[node] = n
            prim_order.extend(prims.tolist())
            continue

        c = centroid[prims]
        c_lo = c.min(axis=0)
        c_hi = c.max(axis=0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:
            # degenerate: split in half arbitrarily
            order = np.argsort(c[:, axis], kind="stable")
            mid = n // 2
            left_p, right_p = prims[order[:mid]], prims[order[mid:]]
        else:
            # binned SAH
            rel = (c[:, axis] - c_lo[axis]) / extent[axis]
            bins = np.minimum((rel * N_BINS).astype(np.int64), N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            # per-bin bounds
            bin_lo = np.full((N_BINS, 3), np.inf)
            bin_hi = np.full((N_BINS, 3), -np.inf)
            for b in range(N_BINS):
                m = bins == b
                if counts[b]:
                    bin_lo[b] = tri_lo[prims[m]].min(axis=0)
                    bin_hi[b] = tri_hi[prims[m]].max(axis=0)

            def sa(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

            # prefix/suffix sweeps
            lacc_lo = np.minimum.accumulate(bin_lo, axis=0)
            lacc_hi = np.maximum.accumulate(bin_hi, axis=0)
            racc_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
            racc_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            cost = np.full(N_BINS - 1, np.inf)
            for s in range(N_BINS - 1):
                nl = lcount[s]
                nr = n - nl
                if nl == 0 or nr == 0:
                    continue
                cost[s] = nl * sa(lacc_lo[s], lacc_hi[s]) + nr * sa(
                    racc_lo[s + 1], racc_hi[s + 1]
                )
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                order = np.argsort(c[:, axis], kind="stable")
                mid = n // 2
                left_p, right_p = prims[order[:mid]], prims[order[mid:]]
            else:
                mask = bins <= best
                left_p, right_p = prims[mask], prims[~mask]

        li = new_node()
        ri = new_node()
        node_left[node] = li
        node_right[node] = ri
        stack.append((ri, right_p))
        stack.append((li, left_p))

    return BVH(
        node_lo=np.asarray(node_lo, np.float32),
        node_hi=np.asarray(node_hi, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        node_is_leaf=np.asarray(node_is_leaf, bool),
        prim_order=np.asarray(prim_order, np.int32),
    )
