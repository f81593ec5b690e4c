"""HDR image IO: Radiance RGBE (.hdr) and OpenEXR (.exr) readers/writers.

The reference lights its outdoor scenes with a 2048-px HDRI cubemap
imported from `Assets/Environments/resting_place_4k.exr` (the EXR blob
itself is absent — `.MISSING_LARGE_BLOBS:1` — but its .meta records the
import: `textureShape: 2`, `generateCubemap: 6`). Unity's importer did
the decoding there; this module is the equivalent import path here, so
real HDRI files feed `Envmap.from_equirect` directly.

Clean-room implementations from the public format specifications:
- Radiance RGBE: Ward's format — 4-byte RGBE texels, new-style RLE
  scanlines (Radiance file formats doc).
- OpenEXR: single-part scanline images, compression NONE / ZIPS / ZIP,
  HALF or FLOAT channels (OpenEXR file layout doc). This covers what
  `resting_place_4k.exr`-class HDRIs actually use; PIZ/EXR2 deep files
  are out of scope and raise.

No third-party imaging dependencies: numpy + zlib only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr)
# ---------------------------------------------------------------------------


def _rgbe_encode(img: np.ndarray) -> np.ndarray:
    """[H,W,3] float -> [H,W,4] uint8 RGBE."""
    img = np.maximum(np.asarray(img, np.float32), 0.0)
    maxc = img.max(axis=-1)
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    nz = maxc >= 1e-32
    # frexp: maxc = frac * 2**exp with frac in [0.5, 1)
    frac, exp = np.frexp(maxc[nz])
    scale = frac * 256.0 / maxc[nz]
    out[nz, 0] = np.minimum(img[nz, 0] * scale, 255).astype(np.uint8)
    out[nz, 1] = np.minimum(img[nz, 1] * scale, 255).astype(np.uint8)
    out[nz, 2] = np.minimum(img[nz, 2] * scale, 255).astype(np.uint8)
    out[nz, 3] = (exp + 128).astype(np.uint8)
    return out


def _rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBE -> [..., 3] float32."""
    rgbe = rgbe.astype(np.float32)
    exp = rgbe[..., 3]
    scale = np.where(exp > 0.0, np.ldexp(1.0, exp.astype(np.int32) - 136),
                     0.0).astype(np.float32)
    return rgbe[..., :3] * scale[..., None]


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write [H,W,3] float32 as a Radiance .hdr with new-style RLE."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    rgbe = _rgbe_encode(img)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            row = rgbe[y]  # [W, 4]
            f.write(struct.pack(">BBH", 2, 2, w))
            for c in range(4):
                comp = row[:, c].tobytes()
                # simple RLE: runs of >=4 identical bytes
                out = bytearray()
                i = 0
                while i < len(comp):
                    run = 1
                    while (i + run < len(comp) and run < 127
                           and comp[i + run] == comp[i]):
                        run += 1
                    if run >= 4:
                        out.append(128 + run)
                        out.append(comp[i])
                        i += run
                    else:
                        j = i
                        while (j < len(comp) and j - i < 128
                               and not (j + 3 < len(comp)
                                        and comp[j] == comp[j + 1]
                                        == comp[j + 2] == comp[j + 3])):
                            j += 1
                        out.append(j - i)
                        out.extend(comp[i:j])
                        i = j
                f.write(bytes(out))


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr -> [H,W,3] float32 (flat or new-style RLE)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].decode().split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {dims}")
    h, w = int(dims[1]), int(dims[3])
    pos = eol + 1
    rows = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4  # new-style RLE scanline
            for c in range(4):
                x = 0
                while x < w:
                    code = data[pos]
                    pos += 1
                    if code > 128:  # run
                        rows[y, x:x + code - 128, c] = data[pos]
                        pos += 1
                        x += code - 128
                    else:  # literal
                        rows[y, x:x + code, c] = np.frombuffer(
                            data, np.uint8, code, pos)
                        pos += code
                        x += code
        else:  # flat scanline
            rows[y] = np.frombuffer(
                data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    return _rgbe_decode(rows)


# ---------------------------------------------------------------------------
# OpenEXR scanline (.exr)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_ZIP_LINES = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstr(data, pos):
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _exr_unpredict(raw: bytes) -> bytes:
    """EXR zip post-processing: undo delta predictor + deinterleave."""
    b = bytearray(raw)
    for i in range(1, len(b)):
        b[i] = (b[i] + b[i - 1] - 128) & 0xFF
    half = (len(b) + 1) // 2
    out = bytearray(len(b))
    out[0::2] = b[:half]
    out[1::2] = b[half:]
    return bytes(out)


def _exr_predict(raw: bytes) -> bytes:
    """Inverse of _exr_unpredict (for the writer)."""
    half = (len(raw) + 1) // 2
    b = bytearray(len(raw))
    b[:half] = raw[0::2]
    b[half:] = raw[1::2]
    for i in range(len(b) - 1, 0, -1):
        b[i] = (b[i] - b[i - 1] + 128) & 0xFF
    return bytes(b)


def read_exr(path: str) -> np.ndarray:
    """Read a single-part scanline EXR -> [H,W,3] float32 (RGB).

    Supports NONE/ZIPS/ZIP compression and HALF/FLOAT channels. Extra
    channels (e.g. A) are parsed and ignored.
    """
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200 or version & 0x800:
        raise ValueError("tiled / multi-part EXR not supported")
    pos = 8

    channels = []  # (name, pixel_type)
    compression = None
    data_window = None
    while True:
        name, pos = _read_cstr(data, pos)
        if not name:
            break
        atype, pos = _read_cstr(data, pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                cname, cp = _read_cstr(payload, cp)
                ptype = struct.unpack_from("<i", payload, cp)[0]
                cp += 16  # pixel type + pLinear/reserved + sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)
    if compression not in _ZIP_LINES:
        raise ValueError(f"unsupported EXR compression {compression}")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lines_per_block = _ZIP_LINES[compression]
    nblocks = -(-h // lines_per_block)

    # channels are stored alphabetically; compute per-line layout
    channels.sort(key=lambda c: c[0])
    dtypes = {_PIX_HALF: np.float16, _PIX_FLOAT: np.float32,
              _PIX_UINT: np.uint32}
    csizes = [(n, dtypes[t], np.dtype(dtypes[t]).itemsize)
              for n, t in channels]
    line_bytes = sum(w * s for _, _, s in csizes)

    offsets = struct.unpack_from(f"<{nblocks}q", data, pos)
    out = {n: np.zeros((h, w), np.float32) for n, _, _ in csizes}
    for off in offsets:
        y, size = struct.unpack_from("<iq", data, off)[0], None
        y_rel = y - y0
        size = struct.unpack_from("<i", data, off + 4)[0]
        raw = data[off + 8:off + 8 + size]
        nlines = min(lines_per_block, h - y_rel)
        expect = line_bytes * nlines
        if compression == _COMP_NONE:
            block = raw
        elif len(raw) == expect:
            # Spec-sanctioned stored-raw chunk: a ZIP block is written
            # uncompressed when deflate does not shrink it (write_exr
            # below emits these too).
            block = raw
        else:
            block = zlib.decompress(raw)
            if len(block) != expect:
                raise ValueError("bad EXR zip block size")
            block = _exr_unpredict(block)
        bp = 0
        for li in range(nlines):
            for cname, dt, s in csizes:
                arr = np.frombuffer(block, dt, w, bp)
                out[cname][y_rel + li] = arr.astype(np.float32)
                bp += w * s
    try:
        return np.stack([out["R"], out["G"], out["B"]], axis=-1)
    except KeyError as e:
        raise ValueError(f"EXR lacks RGB channels: {list(out)}") from e


def write_exr(path: str, img: np.ndarray,
              compression: str = "zip") -> None:
    """Write [H,W,3] float32 RGB as a single-part scanline EXR
    (FLOAT channels, ZIP or NONE compression)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    comp = {"none": _COMP_NONE, "zip": _COMP_ZIP}[compression]
    lines_per_block = _ZIP_LINES[comp]

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chan = b""
    for c in "BGR":  # alphabetical
        chan += c.encode() + b"\x00" + struct.pack(
            "<iiii", _PIX_FLOAT, 0, 1, 1)
    chan += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chan)
        + attr("compression", "compression", bytes([comp]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    nblocks = -(-h // lines_per_block)
    blocks = []
    for b in range(nblocks):
        y = b * lines_per_block
        nlines = min(lines_per_block, h - y)
        parts = []
        for li in range(nlines):
            for c in (2, 1, 0):  # B, G, R alphabetical
                parts.append(img[y + li, :, c].tobytes())
        raw = b"".join(parts)
        if comp == _COMP_NONE:
            payload = raw
        else:
            payload = zlib.compress(_exr_predict(raw))
            if len(payload) >= len(raw):
                payload = raw  # EXR stores raw if zip doesn't shrink
        blocks.append(struct.pack("<ii", y, len(payload)) + payload)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        table_pos = f.tell() + 8 * nblocks
        off = table_pos
        for blk in blocks:
            f.write(struct.pack("<q", off))
            off += len(blk)
        for blk in blocks:
            f.write(blk)


def load_envmap(path: str, num_mips: int = 6):
    """Load a .hdr / .exr file into an `Envmap` (equirectangular)."""
    from halogen_tpu.scene.envmap import Envmap

    lower = path.lower()
    if lower.endswith(".hdr"):
        img = read_hdr(path)
    elif lower.endswith(".exr"):
        img = read_exr(path)
    else:
        raise ValueError(f"unsupported envmap format: {path}")
    return Envmap.from_equirect(img, num_mips=num_mips)


def procedural_hdri(width: int = 2048, seed: int = 11) -> np.ndarray:
    """A resting_place_4k-class stand-in: 2:1 equirect sky with sun
    disc, horizon glow, and ground bounce — HDR range up to ~2000.
    (The reference's actual EXR is a missing large blob,
    `.MISSING_LARGE_BLOBS:1`.)"""
    h = width // 2
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.linspace(0, 1, h, endpoint=False),
                       np.linspace(0, 1, width, endpoint=False),
                       indexing="ij")
    theta = v * np.pi  # 0 = up
    phi = u * 2 * np.pi
    d = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  np.sin(theta) * np.sin(phi)], -1)
    sun_dir = np.array([0.45, 0.65, 0.61])
    sun_dir /= np.linalg.norm(sun_dir)
    cosang = (d @ sun_dir).clip(-1, 1)
    sky_t = (d[..., 1] * 0.5 + 0.5)
    sky = (np.array([0.35, 0.55, 0.95])[None, None] * sky_t[..., None]
           + np.array([0.9, 0.75, 0.6])[None, None]
           * (1 - sky_t[..., None]))
    sun = 2000.0 * np.exp((cosang - 1.0) * 4000.0)[..., None] \
        * np.array([1.0, 0.93, 0.85])
    halo = 6.0 * np.exp((cosang - 1.0) * 40.0)[..., None] \
        * np.array([1.0, 0.9, 0.75])
    ground = np.array([0.25, 0.22, 0.18])[None, None] \
        * np.ones_like(sky)
    img = np.where(d[..., 1:2] > 0, sky + halo, ground * 0.7) + sun
    # low-frequency cloud noise
    for octv in (4, 9):
        ph = rng.uniform(0, 2 * np.pi, 2)
        img *= 1.0 + 0.12 * np.cos(octv * phi + ph[0])[..., None] \
            * np.sin(octv * theta + ph[1])[..., None] \
            * (d[..., 1:2] > 0)
    return np.maximum(img, 0.0).astype(np.float32)


def write_stand_in_exr(path: str, width: int = 2048) -> None:
    """Write the procedural resting_place_4k stand-in (`procedural_hdri`)
    to an EXR file, so configurations that import the reference's
    2048-px HDRI go through the real file loader (`load_envmap`)."""
    write_exr(path, procedural_hdri(width))
