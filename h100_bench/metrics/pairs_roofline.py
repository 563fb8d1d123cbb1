"""Share of the roofline of the WVT pair work, in %.  Moves
``wvt_updates_per_s``.

The work is what the inputs need, whatever kernel does it: every WVT
iteration of every gas lane needs one density evaluation and one
displacement over its neighbours at the solved smoothing length, and
the definition of that length puts DESNNGB of them within it (the
kernel-weighted count wkNgb = 4 pi / 3 h^3 sum W is the expected number
of particles within h).  Retries, further Newton passes and pairs a
kernel tests and rejects are the implementation's cost, not work the
inputs need, and no kernel's own ``stats=`` is read.

Operations a pair (fp32, a fused multiply-add counted as two):

* density (WC6, sph.c:86-140): separation 3 subtractions, r^2 5, sqrt 1;
  u = r / h 1 (1/h once a lane); t = 1 - u 1; t^2, t^4, t^8 3; the
  polynomial 1 + u (8 + u (25 + 32 u)) 3 FMA = 6; W 1; sum W 1;
  dW/dr: t^7 2, (16 u + 7) u + 1 2 FMA = 4, times u and t^7 2; the
  grad-h sum r dW 2: 32 in all;
* displacement (wvt_relax.c:110-160), on the same separation: hbar 2,
  1 / hbar 1, u 1, t 1, t^2, t^4, t^8 3, the polynomial 6, W 1, 1 / r 1,
  h_i W / r 2, three FMA into the sum 6: 24 in all.

M4 (the cubic spline, DESNNGB 50): density 8 + 1 + 1 + 5 (a branch's
polynomial) + 1 + 1 + 4 (its derivative) + 2 = 23, displacement 18.

Bytes a lane and iteration, each input read once and each output written
once: position 12, start, cap and model smoothing length 12; density,
smoothing length, grad-h factor and count 16, done flag 1, displacement
12: 53.

The time is the summed device time, inside the WVT loop's spans, of the
pair kernels below (the kernels of replayed CUDA graphs are device ops
of their own in the trace).  A kernel renamed or replaced leaves the
metric unread until this list names it.  The bound is the larger of the
operations over 67 TFLOP/s (fp32, no tensor cores) and the bytes over
3.35 TB/s, NVIDIA's published peaks of the H100 SXM at its 700 W
limit; at DESNNGB 295 the operations bound it (16,520 operations a lane
and iteration against 53 bytes).
"""

from benchlib.devtrace import WVT_SPAN

KERNELS = ("stream_wvt_kernel", "solve_density_kernel",
           "wvt_displacement_kernel", "fused_wvt_kernel")
OPS_PAIR = {"wc6": 32 + 24, "m4": 23 + 18}
BYTES_LANE = 53
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_seconds(lane_iterations, desnngb, kernel):
    """The least time the card could take for the pair work of
    ``lane_iterations`` gas lane iterations."""
    ops = lane_iterations * desnngb * OPS_PAIR[kernel]
    return max(ops / PEAK_FLOPS, lane_iterations * BYTES_LANE / PEAK_BYTES)


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.op_seconds(KERNELS, WVT_SPAN)
    if launches == 0 or seconds <= 0:
        return None
    lane_its = sum(ic.n_gas * f["iterations"]
                   for ic in run.ics for _, f in ic.stage("wvt_done"))
    bound = bound_seconds(lane_its, run.facts["desnngb"], run.facts["kernel"])
    return 100.0 * bound / seconds
