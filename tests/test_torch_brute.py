"""The port's neighbour engines against the O(N^2) oracles of
``ops/brute.py`` (the reference's own check: Find_ngb_simple in place of
the tree, wvt_relax.c:134).

On a centrally concentrated cloud of 2,000 particles in a periodic box,
the call of one WVT iteration (the stream engine's ``stream_wvt``, the
count-class engine's ``fused_wvt`` and its two-pass ``solve_density`` +
``wvt_displacement``) is held against ``brute_density`` and
``brute_wvt_displacement``, and the B-field curl of both engines against
``brute_curl``.  The oracles walk no candidate list, so they also check
the lists.  On the CPU the engines run their plain versions; the
``cuda`` cases run the hand-written kernels and skip without a card.

The file imports no JAX (run it on the card with ``--noconftest``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from toycluster_tpu_torch.models import bfield
from toycluster_tpu_torch.models import sph as sph_mod
from toycluster_tpu_torch.models import wvt as wvt_mod
from toycluster_tpu_torch.ops import blocks as blk
from toycluster_tpu_torch.ops import brute

BOX = 1000.0
N = 2000
DESNNGB = 64
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
KERNELS = ["wc6", "m4"]


def _device(name):
    """The device, or a skip: decided inside the test, never at import."""
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


@pytest.fixture(scope="module")
def cloud():
    """Plummer-like cloud (multi-scale hsml), its starting hsml and the
    WVT metric hsml (box units)."""
    rng = np.random.default_rng(42)
    r = 80.0 * (rng.random(N) ** 2 / (1 - rng.random(N) * 0.7))
    r = np.clip(r, 0, 420.0)
    u = rng.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = torch.as_tensor(((BOX / 2 + r[:, None] * u) % BOX)
                          .astype(np.float32))
    c = torch.full((3,), BOX / 2)
    h0 = torch.clamp(10.0 + torch.linalg.vector_norm(pos - c, dim=-1)
                     * 0.2, 10.0, 100.0)
    return dict(pos=pos, h0=h0, hm=h0 / BOX * 1.2,
                apot=torch.as_tensor(rng.random((N, 3)).astype(np.float32)))


_ORACLES = {}


def _oracle(cloud, kernel):
    """brute_density and brute_wvt_displacement (step 1) on the CPU."""
    if kernel not in _ORACLES:
        rho, h, vf, wk, done = brute.brute_density(
            cloud["pos"], cloud["h0"], 1.0, BOX, kernel=kernel,
            desnngb=DESNNGB)
        assert float(done.float().mean()) > 0.999
        _ORACLES[kernel] = dict(
            rho=rho, h=h, vf=vf, done=done,
            delta=brute.brute_wvt_displacement(cloud["pos"], cloud["hm"],
                                               1.0, BOX, kernel=kernel))
    return _ORACLES[kernel]


def _unsort(bi, x):
    """Sorted, padded rows back to the cloud's order, on the CPU."""
    x = x.reshape(bi.n_padded, -1)[:N].cpu()
    out = torch.empty_like(x)
    out[bi.order.cpu()] = x
    return out.squeeze(-1)


def _wvt_call(cloud, engine, kernel, dev, h_cap):
    """One WVT iteration's density solve and displacement (step 1, box
    units) as the loop calls it, in the cloud's order."""
    pos = cloud["pos"].to(dev)
    build = (sph_mod.build_neighbours if engine == "stream"
             else sph_mod.build_neighbours_blocks)
    state = build(pos, h_cap.to(dev), BOX,
                  radius_sym_gas=cloud["hm"].to(dev) * BOX
                  * wvt_mod.SYM_MARGIN)
    bi = state.index
    nb = bi.n_blocks

    def pad(x):
        return sph_mod.pad_sorted(x.to(dev), bi.order, bi.n_padded)

    valid = bi.valid
    h0_s, hm_s = pad(cloud["h0"]), pad(cloud["hm"])
    hm_src = torch.where(valid, hm_s, torch.zeros_like(hm_s))
    if engine == "stream":
        src, pos_t = sph_mod.source_blocks(bi.pos, hm_src)
        out = wvt_mod.stream_wvt(
            src, state.cand.idx, state.cand.count, pos_t,
            h0_s.reshape(nb, blk.BLOCK), state.h_cap.reshape(nb, blk.BLOCK),
            hm_s.reshape(nb, blk.BLOCK), 1.0, BOX, kernel=kernel,
            desnngb=DESNNGB, do_disp=True)
    else:
        loop = wvt_mod._Loop.__new__(wvt_mod._Loop)
        loop.kernel, loop.desnngb, loop.mpart, loop.boxsize = (
            kernel, DESNNGB, 1.0, BOX)
        out = loop.solve_classed(state, bi.pos, h0_s, state.h_cap, hm_s,
                                 hm_src, valid)
    rho, h, vf, wk, done, delta = (_unsort(bi, x) for x in out)
    return dict(rho=rho, h=h, done=done.bool(), delta=delta,
                cap=_unsort(bi, state.h_cap))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("engine", ["stream", "classed", "classed_two_pass"])
def test_wvt_iteration_matches_brute(cloud, engine, kernel, device,
                                     monkeypatch):
    """From a warm start (the oracle's h scattered by up to e^0.25, as
    the previous iteration's h would be): every lane done and below its
    cap; rho equal to direct summation at the engine's own h (rtol 1e-4);
    h within rtol 2e-3 of the oracle's solve on > 99% of the lanes and
    within 1e-2 on all (both solves stop anywhere inside the neighbour
    window); the displacement rtol 1e-3.  ``classed_two_pass`` sends
    every count class through solve_density + wvt_displacement."""
    dev = _device(device)
    if engine == "classed_two_pass":
        monkeypatch.setattr(wvt_mod, "FUSED_WIDTH", 0)
    ref = _oracle(cloud, kernel)
    scatter = np.random.default_rng(1).uniform(-0.25, 0.25, N)
    h0 = ref["h"] * torch.as_tensor(np.exp(scatter).astype(np.float32))
    got = _wvt_call(dict(cloud, h0=h0), engine.split("_")[0], kernel, dev,
                    torch.maximum(h0, ref["h"]) * 1.5)
    assert bool(got["done"].all())
    assert not bool((got["h"] >= got["cap"] * 0.999).any())
    direct = brute.density_at(cloud["pos"], got["h"], cloud["pos"], 1.0,
                              BOX, kernel=kernel, desnngb=DESNNGB)
    torch.testing.assert_close(got["rho"], direct, rtol=1e-4, atol=0)
    dh = ((got["h"] - ref["h"]).abs() / ref["h"])[ref["done"]]
    assert float((dh < 2e-3).float().mean()) > 0.99
    assert float(dh.max()) < 1e-2
    scale = float(ref["delta"].abs().max())
    assert scale > 0
    torch.testing.assert_close(got["delta"], ref["delta"], rtol=1e-3,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("engine", ["stream", "classed"])
def test_curl_matches_brute(cloud, engine, kernel, device):
    """The B-field stage's curl (superblock lists on the stream engine,
    block lists per count class on the classed engine) at the oracle's
    h, rho and var_hsml_fac: rtol 5e-3, atol 1e-4 of the largest
    component."""
    dev = _device(device)
    ref = _oracle(cloud, kernel)
    build = (sph_mod.build_neighbours if engine == "stream"
             else sph_mod.build_neighbours_blocks)
    state = build(cloud["pos"].to(dev), ref["h"].to(dev) * 1.01, BOX)
    scene = SimpleNamespace(mpart_gas=1.0, boxsize=BOX,
                            config=SimpleNamespace(sph_kernel=kernel))
    parts = SimpleNamespace(
        n_gas=N, pos=cloud["pos"].to(dev), hsml=ref["h"].to(dev),
        rho=ref["rho"].to(dev), var_hsml_fac=ref["vf"].to(dev),
        apot=cloud["apot"].to(dev))
    got = bfield.sph_curl(scene, parts, state).cpu()
    want = brute.brute_curl(cloud["pos"], ref["h"], ref["rho"], ref["vf"],
                            cloud["apot"], 1.0, BOX, kernel=kernel)
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=5e-3, atol=1e-4 * scale)
