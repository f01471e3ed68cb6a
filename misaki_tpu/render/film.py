"""Film accumulation and development — the wavefront replacement for
ImageBlock/BlockGenerator/HDRFilm (reference: src/librender/imageblock.cpp,
films/hdrfilm.cpp).

The reference renders 32x32 spiral tiles into per-thread blocks with a
discretized-filter splat, merged under a mutex. Here the film is a
channel-major flat accumulator (C, H*W + guard) in device memory, and the
wavefront is **pixel-major** (lane = pixel * spp + s): a chunk covers a
contiguous flat pixel range, so each reconstruction-filter tap offset
(ox, oy) is a constant flat shift oy*W + ox for every lane. The whole splat becomes (2r+1)^2 dense
shifted adds — zero scatters, no tiles, no borders, no locks, deterministic.

The gaussian is evaluated exactly instead of via the reference's 32-bin LUT
(rfilter.h eval_discretized) — a CPU-era optimization that would only add
error here.
"""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np

from misaki_tpu.core import spectrum as spec


def filter_footprint(filter_type, stddev):
    """Static footprint half-width in pixels."""
    if filter_type == "box":
        return 0, 0.5
    radius = 4.0 * stddev  # gaussian.cpp: m_radius = 4 * stddev
    return int(np.ceil(radius)), radius


def pad_rows(W, filter_type, stddev):
    pad, _ = filter_footprint(filter_type, stddev)
    return (pad + 1) * W + pad + 1


def new_film_flat(H, W, channels=5, filter_type="gaussian", stddev=0.5):
    guard = pad_rows(W, filter_type, stddev)
    return jnp.zeros((channels, H * W + 2 * guard), jnp.float32)


def splat_aligned(
    film_flat, pixel0, pos, values, W, H, spp, filter_type="gaussian", stddev=0.5
):
    """Scatter-free splat for spp-aligned pixel-major chunks.

    film_flat: (C, H*W + 2*guard); pixel0: first flat pixel id (traced ok);
    pos: (px, py) tuple of (L,); values: tuple of C (L,) channel arrays;
    L = n_pix * spp.
    """
    C = len(values)
    L = values[0].shape[0]
    n_pix = L // spp
    guard = pad_rows(W, filter_type, stddev)
    pad, radius = filter_footprint(filter_type, stddev)

    pix = pixel0 + jnp.arange(n_pix, dtype=jnp.int32)
    px0 = (pix % W).astype(jnp.float32)
    py0 = (pix // W).astype(jnp.float32)

    v = jnp.stack(values, 0).reshape(C, n_pix, spp)
    # jitter relative to the pixel corner, in discrete coords (-0.5-centered)
    jx = pos[0].reshape(n_pix, spp) - px0[:, None] - 0.5
    jy = pos[1].reshape(n_pix, spp) - py0[:, None] - 0.5

    if filter_type == "box":
        taps = [(0, 0)]

        def wfun(o, j):
            return jnp.ones_like(j)
    else:
        alpha = -1.0 / (2.0 * stddev * stddev)
        bias = np.exp(alpha * radius * radius)
        taps = [(ox, oy) for oy in range(-pad, pad + 1) for ox in range(-pad, pad + 1)]

        def wfun(o, j):
            return jnp.maximum(jnp.exp(alpha * (o - j) ** 2) - bias, 0.0)

    offs = sorted({o for t in taps for o in t})
    wx_all = {o: wfun(o, jx) for o in offs}  # (n_pix, spp)
    wy_all = {o: wfun(o, jy) for o in offs}
    in_x = {o: ((px0 + o >= 0) & (px0 + o < W)).astype(jnp.float32) for o in offs}
    in_y = {o: ((py0 + o >= 0) & (py0 + o < H)).astype(jnp.float32) for o in offs}

    if isinstance(pixel0, int):
        # static-offset path (single-chunk frames, pixel0 == 0): every tap's
        # flat shift is a compile-time constant, so the (2r+1)^2 adds become
        # ONE fused elementwise pass over a padded-sum — the dynamic-slice
        # formulation below walks the film 25 times (~0.6 GB of device-memory
        # traffic per 590k-pixel gaussian splat)
        flat = film_flat.shape[1]
        acc = None
        for ox, oy in taps:
            w = wx_all[ox] * wy_all[oy] * (in_x[ox] * in_y[oy])[:, None]
            contrib = jnp.sum(w[None, :, :] * v, axis=2)  # (C, n_pix)
            off = guard + pixel0 + oy * W + ox
            term = jnp.pad(contrib, ((0, 0), (off, flat - off - n_pix)))
            acc = term if acc is None else acc + term
        return film_flat + acc

    # The frame's last chunk may reach past the film's end. XLA clamps a
    # dynamic slice that would leave its operand, which would shift the
    # chunk's whole splat, so the taps land in a copy padded by one chunk.
    flat = film_flat.shape[1]
    film_ext = jnp.pad(film_flat, ((0, 0), (0, n_pix)))
    for ox, oy in taps:
        w = wx_all[ox] * wy_all[oy] * (in_x[ox] * in_y[oy])[:, None]
        contrib = jnp.sum(w[None, :, :] * v, axis=2)  # (C, n_pix)
        start = guard + pixel0 + oy * W + ox
        seg = jax.lax.dynamic_slice(film_ext, (0, start), (C, n_pix))
        film_ext = jax.lax.dynamic_update_slice(film_ext, seg + contrib,
                                                (0, start))
    return film_ext[:, :flat]


def film_from_flat(film_flat, H, W, filter_type="gaussian", stddev=0.5):
    """(C, flat) accumulator -> (H, W, C) image-layout film."""
    guard = pad_rows(W, filter_type, stddev)
    C = film_flat.shape[0]
    return jnp.moveaxis(film_flat[:, guard : guard + H * W], 0, -1).reshape(H, W, C)


def develop(film):
    """XYZAW (H, W, 5) -> linear sRGB + alpha (hdrfilm.cpp:44-88)."""
    xyz = film[..., 0:3]
    alpha = film[..., 3]
    weight = film[..., 4]
    inv_w = jnp.where(weight != 0.0, 1.0 / weight, 0.0)
    rgb = spec.xyz_to_srgb_image(xyz) * inv_w[..., None]
    return rgb, alpha * inv_w


def to_srgb8(rgb):
    """Linear -> sRGB gamma, 8-bit (bitmap.cpp tonemap for PNG output)."""
    rgb = np.clip(np.asarray(rgb), 0.0, 1.0)
    srgb = np.where(
        rgb <= 0.0031308, 12.92 * rgb, 1.055 * rgb ** (1 / 2.4) - 0.055
    )
    return (srgb * 255.0 + 0.5).astype(np.uint8)


def write_exr(path, rgb, alpha=None):
    """Uncompressed scanline OpenEXR with float32 channels (replaces OIIO,
    image.cpp:21-44). rgb: (H, W, 3) -> R, G, B; (H, W) -> one Y channel;
    alpha (H, W) adds an A channel."""
    img = np.asarray(rgb, np.float32)
    chans = {"Y": img} if img.ndim == 2 else {
        "R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    if alpha is not None:
        chans["A"] = np.asarray(alpha, np.float32)
    names = sorted(chans)  # EXR stores channels in name order
    H, W = chans[names[0]].shape

    def attr(name, kind, value):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    chlist = b"".join(
        n.encode() + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1)  # 2 = FLOAT
        for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (
        struct.pack("<ii", 20000630, 2)  # magic, version 2 (scanline)
        + attr("channels", "chlist", chlist)
        + attr("compression", "compression", b"\0")  # NO_COMPRESSION
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")  # INCREASING_Y
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    # one scanline per block: y, byte count, then each channel's W floats
    rows = np.stack([chans[n] for n in names], axis=1)  # (H, C, W)
    line_bytes = rows.shape[1] * W * 4
    first = len(header) + 8 * H
    offsets = first + np.arange(H, dtype=np.uint64) * (8 + line_bytes)
    blocks = b"".join(
        struct.pack("<ii", y, line_bytes) + rows[y].astype("<f4").tobytes()
        for y in range(H))
    with open(path, "wb") as f:
        f.write(header + offsets.astype("<u8").tobytes() + blocks)


def read_exr(path):
    """Read a file written by `write_exr` (uncompressed float32 scanlines)
    -> {channel name: (H, W) float32}."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack_from("<i", data, 0)[0] != 20000630:
        raise ValueError(f"{path}: not an OpenEXR file")
    pos, attrs = 8, {}
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        kind_end = data.index(b"\0", name_end + 1)
        (size,) = struct.unpack_from("<i", data, kind_end + 1)
        attrs[data[pos:name_end].decode()] = data[kind_end + 5:
                                                  kind_end + 5 + size]
        pos = kind_end + 5 + size
    if attrs["compression"] != b"\0":
        raise ValueError(f"{path}: only uncompressed EXR is supported")
    names, chl = [], attrs["channels"]
    while chl[0] != 0:
        end = chl.index(b"\0")
        names.append(chl[:end].decode())
        chl = chl[end + 17:]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    H, W, C = y1 - y0 + 1, x1 - x0 + 1, len(names)
    offsets = np.frombuffer(data, "<u8", H, pos + 1)
    rows = np.stack([
        np.frombuffer(data, "<f4", C * W, int(off) + 8).reshape(C, W)
        for off in offsets])  # (H, C, W)
    return {n: rows[:, i, :].astype(np.float32) for i, n in enumerate(names)}


def write_png(path, rgb):
    """8-bit sRGB PNG (filter type 0 scanlines, one zlib IDAT)."""
    img = to_srgb8(rgb)
    H, W = img.shape[:2]
    raw = np.concatenate(
        [np.zeros((H, 1), np.uint8), img.reshape(H, W * 3)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
