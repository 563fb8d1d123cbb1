"""Gadget-1 snapshot writer and reader (reference src/io.c:13-287, io.h).

JAX counterpart: ``toycluster_tpu/io/gadget.py`` (without its chunked
device-streaming fetcher: tensors are copied to host NumPy once and
written from there).  Every block is an F90 unformatted record pair: an
8-byte label record (4-char tag + int32 "nextblock" size) and the data
record, each bracketed by int32 record lengths.  Blocks, in order: HEAD,
POS, VEL, ID, U, RHO, HSML, BFLD, RHOM (io.h:31-41); the gas-only blocks
cover particle type 0.  Data is little-endian float32 / uint32; particle
masses ride in the header.  Empty blocks keep their framing (io.c:85-133).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_HEADER_FMT = "<6i6d d d i i 6I i i d d d d i i 6I 64s"
assert struct.calcsize(_HEADER_FMT) == 256


@dataclass
class GadgetHeader:
    npart: list
    mass: list
    time: float = 0.0
    redshift: float = 0.0
    flag_sfr: int = 0
    flag_feedback: int = 0
    npart_total: list = None
    flag_cooling: int = 0
    num_files: int = 1
    boxsize: float = 0.0
    omega0: float = 1.0          # io.c:63
    omega_lambda: float = 0.7    # io.c:64
    hubble_param: float = 0.7    # io.c:65 (Cosmo.h_100)
    flag_stellarage: int = 0
    flag_metals: int = 0

    def __post_init__(self):
        if self.npart_total is None:
            self.npart_total = list(self.npart)

    def pack(self) -> bytes:
        return struct.pack(
            _HEADER_FMT, *self.npart, *self.mass, self.time, self.redshift,
            self.flag_sfr, self.flag_feedback, *self.npart_total,
            self.flag_cooling, self.num_files, self.boxsize, self.omega0,
            self.omega_lambda, self.hubble_param, self.flag_stellarage,
            self.flag_metals, 0, 0, 0, 0, 0, 0, b"")

    @classmethod
    def unpack(cls, raw: bytes) -> "GadgetHeader":
        v = struct.unpack(_HEADER_FMT, raw)
        return cls(npart=list(v[0:6]), mass=list(v[6:12]), time=v[12],
                   redshift=v[13], flag_sfr=v[14], flag_feedback=v[15],
                   npart_total=list(v[16:22]), flag_cooling=v[22],
                   num_files=v[23], boxsize=v[24], omega0=v[25],
                   omega_lambda=v[26], hubble_param=v[27],
                   flag_stellarage=v[28], flag_metals=v[29])


def _rec(payload: bytes) -> bytes:
    n = struct.pack("<i", len(payload))
    return n + payload + n


# block table: (label, gas_only, values_per_element, dtype)
BLOCKS = (
    ("POS ", False, 3, np.float32),
    ("VEL ", False, 3, np.float32),
    ("ID  ", False, 1, np.uint32),
    ("U   ", True, 1, np.float32),
    ("RHO ", True, 1, np.float32),
    ("HSML", True, 1, np.float32),
    ("BFLD", True, 3, np.float32),
    ("RHOM", True, 1, np.float32),
)


def _host(arr, dtype):
    if hasattr(arr, "detach"):          # a tensor, on any device
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr, dtype)


def write_snapshot(path: str, *, header: GadgetHeader, pos, vel, ids,
                   u=None, rho=None, hsml=None, bfld=None, rho_model=None):
    """Write all blocks in reference order.  Arrays may be NumPy arrays or
    tensors; gas-only arrays may be None when npart[0] == 0."""
    n_gas = header.npart[0]
    data = {"POS ": pos, "VEL ": vel, "ID  ": ids, "U   ": u, "RHO ": rho,
            "HSML": hsml, "BFLD": bfld, "RHOM": rho_model}
    with open(path, "wb") as fp:
        fp.write(_rec(b"HEAD" + struct.pack("<i", 256 + 8)))
        fp.write(_rec(header.pack()))
        for label, gas_only, vpe, dtype in BLOCKS:
            arr = data[label]
            if gas_only:
                arr = (np.zeros((0, vpe), dtype) if arr is None
                       else arr[:n_gas])
            a = _host(arr, dtype)
            nbytes = a.size * a.itemsize
            fp.write(_rec(label.encode("ascii") + struct.pack("<i",
                                                              nbytes + 8)))
            fp.write(struct.pack("<i", nbytes))
            a.tofile(fp)
            fp.write(struct.pack("<i", nbytes))


def read_snapshot(path: str) -> dict:
    """Read a reference-format snapshot back into NumPy arrays."""
    with open(path, "rb") as fp:
        raw = fp.read()
    blocks, off = {}, 0

    def record():
        nonlocal off
        (n,) = struct.unpack_from("<i", raw, off)
        payload = raw[off + 4:off + 4 + n]
        (n2,) = struct.unpack_from("<i", raw, off + 4 + n)
        assert n == n2, "corrupt F90 record"
        off += n + 8
        return payload

    while off < len(raw):
        label = record()[:4].decode("ascii")
        blocks[label.strip()] = record()
    hdr = GadgetHeader.unpack(blocks.pop("HEAD"))
    n_all, n_gas = sum(hdr.npart), hdr.npart[0]

    def arr(label, n, vpe, dtype):
        if label not in blocks:
            return None
        a = np.frombuffer(blocks[label], dtype)
        return a.reshape(n, vpe) if vpe > 1 else a

    return {
        "header": hdr,
        "pos": arr("POS", n_all, 3, np.float32),
        "vel": arr("VEL", n_all, 3, np.float32),
        "ids": arr("ID", n_all, 1, np.uint32),
        "u": arr("U", n_gas, 1, np.float32),
        "rho": arr("RHO", n_gas, 1, np.float32),
        "hsml": arr("HSML", n_gas, 1, np.float32),
        "bfld": arr("BFLD", n_gas, 3, np.float32),
        "rho_model": arr("RHOM", n_gas, 1, np.float32),
    }


def write_scene_snapshot(path: str, scene, parts) -> GadgetHeader:
    """Assemble the header from a Scene and write a Particles."""
    header = GadgetHeader(npart=[scene.npart_gas, scene.npart_dm, 0, 0, 0, 0],
                          mass=[scene.mpart_gas, scene.mpart_dm, 0.0, 0.0,
                                0.0, 0.0],
                          boxsize=float(scene.boxsize),
                          hubble_param=scene.cosmo.h_100)
    bfld = (parts.bfld if parts.bfld.shape[0] == parts.n_gas
            else np.zeros((parts.n_gas, 3), np.float32))
    write_snapshot(path, header=header, pos=parts.pos, vel=parts.vel,
                   ids=parts.pid, u=parts.u, rho=parts.rho, hsml=parts.hsml,
                   bfld=bfld, rho_model=parts.rho_model)
    return header
