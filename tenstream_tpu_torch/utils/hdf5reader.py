"""Minimal pure-python HDF5 reader for "new-style" netCDF4 files (the
port's copy of `tenstream_tpu/utils/hdf5reader.py`, numpy and `struct`
only).

Real ICON grid files are NetCDF4, which is HDF5: `plexrt.icon` falls back
to this reader when a file is not classic NetCDF3.  The files use a small,
fixed subset of the format -- superblock v0, version-2 object headers,
dense root links in one fractal heap, contiguous unfiltered datasets --
which this module reads directly, without libhdf5.

Supported (enough for the repwvl/mie/fu-ice tables and the
reference's regression-result files):
  * superblock v0/v2/v3
  * v2 object headers ('OHDR') with 'OCHK' continuation blocks
  * link discovery from compact link messages AND from fractal-heap
    direct blocks ('FHDB', serialized link messages scanned
    record-by-record)
  * dataspace v1/v2, datatypes: fixed-point, IEEE float, fixed and
    variable-length strings
  * data layout v3: contiguous, compact, and chunked with a v1 B-tree
    chunk index and the gzip (deflate) / shuffle filters

Anything else raises NotImplementedError with a pointer to the feature.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"


class MiniH5:
    def __init__(self, path: str):
        self.data = open(path, "rb").read()
        if self.data[:8] != _SIG:
            raise ValueError(f"{path}: not an HDF5 file")
        self.sver = self.data[8]
        if self.sver == 0:
            # root group symbol table entry: link-name offset (8) at 56,
            # object header address at 64
            self.root = struct.unpack_from("<Q", self.data, 64)[0]
        elif self.sver in (2, 3):
            self.root = struct.unpack_from("<Q", self.data, 40)[0]
        else:
            raise NotImplementedError(f"superblock v{self.sver}")
        self._vars = self._discover_links()

    # ------------------------------------------------------------------
    def _ohdr_messages(self, pos):
        d = self.data
        if d[pos:pos + 4] != b"OHDR":
            raise NotImplementedError(
                f"object header at {pos} is not v2 ('OHDR'); v1 headers "
                "not needed for the supported files")
        flags = d[pos + 5]
        off = pos + 6
        if flags & 0x20:
            off += 16
        if flags & 0x10:
            off += 4
        szb = 1 << (flags & 3)
        size0 = int.from_bytes(d[off:off + szb], "little")
        off += szb
        msgs = []
        blocks = [(off, off + size0)]
        while blocks:
            off, end = blocks.pop()
            while off < end - 3:
                mtype = d[off]
                msize = int.from_bytes(d[off + 1:off + 3], "little")
                off += 4
                if flags & 0x04:
                    off += 2
                if mtype == 0x10:  # continuation -> OCHK block
                    caddr = int.from_bytes(d[off:off + 8], "little")
                    clen = int.from_bytes(d[off + 8:off + 16], "little")
                    assert d[caddr:caddr + 4] == b"OCHK"
                    blocks.append((caddr + 4, caddr + clen - 4))
                else:
                    msgs.append((mtype, off, msize))
                off += msize
        return msgs

    def _scan_link_records(self, blob, out: Dict[str, int]):
        """Walk serialized link messages (hard links) in a byte blob."""
        n = len(self.data)
        i = 0
        while i < len(blob) - 4:
            if blob[i] == 1:  # link message version
                fl = blob[i + 1]
                if fl & ~0x1F == 0:
                    p = i + 2
                    if fl & 0x08:
                        p += 1
                    if fl & 0x04:
                        p += 8
                    if fl & 0x10:
                        p += 1
                    lsz = 1 << (fl & 3)
                    if p + lsz <= len(blob):
                        ln = int.from_bytes(blob[p:p + lsz], "little")
                        name = blob[p + lsz:p + lsz + ln]
                        if 0 < ln <= 64 and name.isascii() and all(
                            32 < c < 127 for c in name
                        ):
                            addr = int.from_bytes(
                                blob[p + lsz + ln:p + lsz + ln + 8], "little"
                            )
                            if 0 < addr < n:
                                out[name.decode()] = addr
                                i = p + lsz + ln + 8
                                continue
            i += 1

    def _discover_links(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        # compact links in the root header
        for mtype, off, msize in self._ohdr_messages(self.root):
            if mtype == 0x06:
                self._scan_link_records(self.data[off:off + msize], out)
        # dense links: scan every fractal-heap direct block
        pos = 0
        while True:
            pos = self.data.find(b"FHDB", pos)
            if pos < 0:
                break
            # header: sig(4) ver(1) heap-hdr-addr(8) block-offset(var);
            # scan the whole block body for link records
            self._scan_link_records(self.data[pos + 13:pos + 13 + 65536], out)
            pos += 4
        return out

    # ------------------------------------------------------------------
    def variables(self):
        return sorted(self._vars)

    def read(self, name: str) -> np.ndarray:
        d = self.data
        if name not in self._vars:
            raise KeyError(f"{name!r} not found; have {self.variables()}")
        dims = None
        dtype = None
        layout = None
        filters = []
        for mtype, off, msize in self._ohdr_messages(self._vars[name]):
            if mtype == 0x01:  # dataspace
                ver, rank = d[off], d[off + 1]
                p = off + (8 if ver == 1 else 4)
                dims = tuple(
                    int.from_bytes(d[p + 8 * i:p + 8 * i + 8], "little")
                    for i in range(rank)
                )
            elif mtype == 0x03:  # datatype
                cls = d[off] & 0x0F
                size = int.from_bytes(d[off + 4:off + 8], "little")
                bits0 = d[off + 1]
                if cls == 0:
                    signed = bool(bits0 & 0x08)
                    dtype = np.dtype(f"<{'i' if signed else 'u'}{size}")
                elif cls == 1:
                    dtype = np.dtype(f"<f{size}")
                elif cls == 3:
                    dtype = np.dtype(f"S{size}")
                elif cls == 9:
                    dtype = "vlen"  # variable-length (strings)
                else:
                    raise NotImplementedError(f"datatype class {cls}")
            elif mtype == 0x08:  # layout
                ver, lcls = d[off], d[off + 1]
                if ver != 3:
                    raise NotImplementedError(f"layout v{ver}")
                if lcls == 1:  # contiguous
                    addr = int.from_bytes(d[off + 2:off + 10], "little")
                    size = int.from_bytes(d[off + 10:off + 18], "little")
                    layout = ("contig", addr, size)
                elif lcls == 0:  # compact
                    size = int.from_bytes(d[off + 2:off + 4], "little")
                    layout = ("compact", off + 4, size)
                elif lcls == 2:  # chunked: v1 B-tree index
                    ndims1 = d[off + 2]
                    baddr = int.from_bytes(d[off + 3:off + 11], "little")
                    cdims = tuple(
                        int.from_bytes(d[off + 11 + 4 * i:off + 15 + 4 * i], "little")
                        for i in range(ndims1)
                    )
                    layout = ("chunked", baddr, cdims)
                else:
                    raise NotImplementedError(f"layout class {lcls}")
            elif mtype == 0x0B:  # filter pipeline
                nf = d[off + 1]
                p = off + (8 if d[off] == 1 else 2)
                filters = []
                for _ in range(nf):
                    fid = int.from_bytes(d[p:p + 2], "little")
                    namelen = int.from_bytes(d[p + 2:p + 4], "little")
                    nval = int.from_bytes(d[p + 6:p + 8], "little")
                    p += 8 + namelen
                    if d[off] == 1 and namelen % 8:
                        p += 8 - namelen % 8
                    p += 4 * nval
                    if d[off] == 1 and nval % 2:
                        p += 4
                    filters.append(fid)
        if dims is None or dtype is None or layout is None:
            raise NotImplementedError(f"{name}: incomplete object header")
        if layout[0] == "chunked":
            return self._read_chunked(layout[1], layout[2], dims, dtype, filters)
        _, addr, size = layout
        if dtype == "vlen":
            return self._read_vlen_strings(addr, dims)
        if addr >= len(d):  # undefined address: never-written dataset
            return np.zeros(dims, dtype=dtype)
        arr = np.frombuffer(d, dtype=dtype, count=int(np.prod(dims)) if dims else 1,
                            offset=addr)
        return arr.reshape(dims)

    def _read_chunked(self, btree_addr, cdims, dims, dtype, filters):
        """v1 B-tree chunk index + gzip/shuffle filters."""
        import zlib

        d = self.data
        ndims1 = len(cdims)
        out = np.zeros(dims, dtype=dtype)
        elsize = dtype.itemsize

        def walk(addr):
            assert d[addr:addr + 4] == b"TREE", "bad chunk btree node"
            level = d[addr + 5]
            nent = int.from_bytes(d[addr + 6:addr + 8], "little")
            p = addr + 24  # past siblings
            for _ in range(nent):
                csize = int.from_bytes(d[p:p + 4], "little")
                offs = tuple(
                    int.from_bytes(d[p + 8 + 8 * i:p + 16 + 8 * i], "little")
                    for i in range(ndims1)
                )
                child = int.from_bytes(d[p + 8 + 8 * ndims1:p + 16 + 8 * ndims1],
                                       "little")
                p += 16 + 8 * ndims1
                if level > 0:
                    walk(child)
                    continue
                raw = d[child:child + csize]
                if 1 in filters:  # deflate
                    raw = zlib.decompress(raw)
                if 2 in filters:  # shuffle: de-interleave bytes
                    a = np.frombuffer(raw, np.uint8)
                    n = a.size // elsize
                    raw = a.reshape(elsize, n).T.tobytes()
                chunk = np.frombuffer(raw, dtype=dtype)
                shape = cdims[:-1]
                chunk = chunk[: int(np.prod(shape))].reshape(shape)
                sl = tuple(
                    slice(o, min(o + s, dims[i]))
                    for i, (o, s) in enumerate(zip(offs[:-1], shape))
                )
                src_sl = tuple(slice(0, s.stop - s.start) for s in sl)
                out[sl] = chunk[src_sl]

        walk(btree_addr)
        return out

    def _read_vlen_strings(self, addr, dims):
        """Variable-length strings: (len u32, global-heap addr u64,
        object index u32) records pointing into 'GCOL' collections."""
        d = self.data
        n = int(np.prod(dims)) if dims else 1
        out = []
        for i in range(n):
            p = addr + 16 * i
            ln = int.from_bytes(d[p:p + 4], "little")
            gaddr = int.from_bytes(d[p + 4:p + 12], "little")
            idx = int.from_bytes(d[p + 12:p + 16], "little")
            assert d[gaddr:gaddr + 4] == b"GCOL", "bad global heap"
            q = gaddr + 16  # sig(4) ver(1) res(3) size(8)
            val = b""
            while q < len(d) - 16:
                oidx = int.from_bytes(d[q:q + 2], "little")
                osize = int.from_bytes(d[q + 8:q + 16], "little")
                if oidx == idx:
                    val = d[q + 16:q + 16 + ln]
                    break
                if oidx == 0:
                    break
                q += 16 + ((osize + 7) // 8) * 8
            out.append(val.decode("utf-8", "replace"))
        return np.array(out).reshape(dims)


def read_all(path: str) -> Dict[str, np.ndarray]:
    f = MiniH5(path)
    return {k: f.read(k) for k in f.variables()}
