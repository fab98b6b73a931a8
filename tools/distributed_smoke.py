#!/usr/bin/env python3
"""Multi-PROCESS ``jax.distributed`` smoke, pinned to virtual CPU devices.

Every worker runs on the CPU (``jax_platforms=cpu``), never on a GPU: one
JAX process per card is the rule, and several workers on one card would
each reserve most of its memory.

The multi-host story (SURVEY §5.8) previously rested on a single-process
8-device dryrun plus analysis; this tool actually crosses a process
boundary: it launches ``--num-processes`` worker subprocesses on localhost,
each owning ``--local-devices`` virtual CPU devices, initializes
``jax.distributed`` (the same coordinator/barrier/collective machinery a
multi-host job uses, over localhost gRPC), builds ONE global mesh
``{"data": num_processes, "signal": local_devices}``, and runs the
signal-sharded MODWT forward + inverse across it.

What this validates that the single-process dryrun cannot:
  * ``parallel.mesh.init_distributed`` really initializes and the global
    device list assembles across processes;
  * ``modwt_sharded``'s per-level halo ``ppermute`` executes across a
    process boundary (the ring's wrap edges live on different processes);
  * global arrays assemble from per-process shards
    (``jax.make_array_from_callback``) and parity holds: each process
    checks its addressable output shards against the single-device oracle
    and the cross-process roundtrip reproduces the input.

``--full`` (VERDICT r3 #2) extends the basic MODWT ring to the ENTIRE
``parallel/sharded.py`` public surface: every entry point runs on meshes
whose collective axis SPANS the process boundary (one global ``signal`` /
``scale`` / ``data`` axis over all devices of all processes — the ring
wrap edges and the subtree all-gathers cross real process boundaries),
with per-family parity asserts against single-device oracles computed on
the replicated input.  Outputs are jitted with fully-replicated
``out_shardings`` so every process can check the whole result locally.

Usage:
    python tools/distributed_smoke.py                 # 2 procs × 4 devices
    python tools/distributed_smoke.py --full          # whole sharded surface
    python tools/distributed_smoke.py --num-processes 2 --local-devices 2 \
        --n 4096 --batch 4

Exit code 0 and a final ``{"ok": true, ...}`` JSON line on success.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Worker (runs in each subprocess)
# ---------------------------------------------------------------------------

def worker(args) -> None:
    # Config updates before first backend use pin the platform, device
    # count and collectives whatever the environment says.  "gloo" is the
    # CPU cross-process collectives backend — without
    # it the CPU client initializes single-process and ignores the
    # coordination service.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.local_devices)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_enable_x64", True)

    sys.path.insert(0, str(REPO))
    from jwave_pro.parallel.mesh import init_distributed

    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes,
                     process_id=args.process_id)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jwave_pro as jw
    from jwave_pro.parallel import make_mesh
    from jwave_pro.parallel.sharded import imodwt_sharded, modwt_sharded

    assert jax.process_count() == args.num_processes, (
        f"process_count={jax.process_count()} != {args.num_processes}")
    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_dev == args.num_processes * n_local, (n_dev, n_local)

    # data axis = process boundary, signal axis = within-process — the
    # layout init_distributed's docstring prescribes.
    # With batch < data-axis size this would fail; keep batch % procs == 0.
    mesh = make_mesh({"data": args.num_processes, "signal": n_local})
    w = jw.wavelet("Daubechies 4")
    level = args.level

    # Same full array in every process (same seed); the global device array
    # is assembled from per-process shards via make_array_from_callback.
    x_np = np.random.default_rng(7).standard_normal(
        (args.batch, args.n)).astype(np.float64)
    sharding = NamedSharding(mesh, P("data", "signal"))
    x = jax.make_array_from_callback(x_np.shape, sharding,
                                     lambda idx: x_np[idx])

    fwd = jax.jit(lambda v: modwt_sharded(v, w, level, mesh))
    inv = jax.jit(lambda c: imodwt_sharded(c, w, mesh))
    coeffs = fwd(x)
    back = inv(coeffs)

    # Parity 1: every ADDRESSABLE shard of the sharded forward matches the
    # single-device oracle computed on the replicated numpy input.
    oracle = np.asarray(jw.modwt(jnp.asarray(x_np), w, level,
                                 method="direct"))
    worst = 0.0
    for shard in coeffs.addressable_shards:
        ref = oracle[tuple(shard.index)]
        worst = max(worst, float(np.max(np.abs(np.asarray(shard.data) - ref))))

    # Parity 2: cross-process roundtrip reproduces the input.
    rt = 0.0
    for shard in back.addressable_shards:
        ref = x_np[tuple(shard.index)]
        rt = max(rt, float(np.max(np.abs(np.asarray(shard.data) - ref))))

    # Parity 3: a psum crossing the process boundary agrees with numpy.
    total = float(jnp.sum(coeffs[level]))
    ref_total = float(np.sum(oracle[level]))
    sum_err = abs(total - ref_total) / max(abs(ref_total), 1e-30)

    ok = worst < 1e-10 and rt < 1e-10 and sum_err < 1e-10

    families = {}
    if args.full:
        families = _full_battery()
        ok = ok and all(v < FULL_TOLS.get(k, FULL_DEFAULT_TOL)
                        for k, v in families.items())

    print(json.dumps({
        "process": args.process_id, "devices": n_dev, "local": n_local,
        "fwd_max_abs_err": worst, "roundtrip_max_abs_err": rt,
        "global_sum_rel_err": sum_err, "families": families, "ok": ok,
    }), flush=True)
    if not ok:
        sys.exit(1)


def _full_battery() -> dict:
    """Run every ``parallel/sharded.py`` entry point across the process
    boundary; return {family: max_abs_err} (vs single-device oracles).

    The collective axis is ONE global mesh axis over all devices of all
    processes (device order is process-major, so ring edges, subtree
    all-gathers, and the ssq psum genuinely cross the boundary).  Inputs
    enter fully replicated; outputs leave fully replicated (the gather
    itself is another cross-process collective under test).
    """
    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import jwave_pro as jw
    from jwave_pro.parallel import sharded as sh

    devs = np.array(jax.devices())
    nd = len(devs)
    mesh_sig = Mesh(devs, ("signal",))
    mesh_scl = Mesh(devs, ("scale",))
    mesh_dat = Mesh(devs, ("data",))
    rng = np.random.default_rng(11)

    def rep(mesh, a):
        a = np.asarray(a)
        return jax.make_array_from_callback(
            a.shape, NamedSharding(mesh, P()), lambda idx: a[idx])

    def run(mesh, fn, *inputs):
        """jit fn with fully-replicated outputs; return local np leaves."""
        out = jax.jit(fn, out_shardings=NamedSharding(mesh, P()))(
            *[rep(mesh, a) for a in inputs])
        return [np.asarray(o.addressable_shards[0].data)
                for o in jax.tree_util.tree_leaves(out)]

    def err(got, want):
        return max(float(np.max(np.abs(np.asarray(g) - np.asarray(w))))
                   for g, w in zip(got, want))

    fam = {}
    w = jw.wavelet("Daubechies 4")
    sym8 = jw.wavelet("Symlet 8")
    x = rng.standard_normal((2, 512 * nd))
    x1 = x[0]

    # --- signal-axis ring families (wrap edges cross the boundary) -------
    got = run(mesh_sig, lambda v: (sh.modwt_sharded(v, w, 3, mesh_sig),
                                   sh.imodwt_sharded(
                                       sh.modwt_sharded(v, w, 3, mesh_sig),
                                       w, mesh_sig)), x)
    fam["modwt_ring"] = err(got, [jw.modwt(x, w, 3, method="direct"), x])

    got = run(mesh_sig,
              lambda v: (sh.gather_fwt_layout(
                             sh.fwt_sharded(v, w, 2, mesh_sig), 2, nd),
                         sh.ifwt_sharded(
                             sh.fwt_sharded(v, w, 2, mesh_sig),
                             w, 2, mesh_sig)), x)
    fam["fwt_ring"] = err(got, [jw.fwt(x, w, 2), x])

    def dt_fn(v):
        r = sh.dtcwt_sharded(v, 2, mesh_sig)
        return (tuple(r.highpass), r.lowpass_a, r.lowpass_b,
                sh.idtcwt_sharded(r, mesh_sig))
    ref = jw.dtcwt(jnp.asarray(x), 2)
    fam["dtcwt_ring"] = err(
        run(mesh_sig, dt_fn, x),
        list(ref.highpass) + [ref.lowpass_a, ref.lowpass_b, x])

    scl_sig = jw.generate_log_scales(5.0, 16.0, 4)
    got = run(mesh_sig, lambda v: sh.cwt_signal_sharded(
        v, scl_sig, jw.MorletWavelet(), mesh_sig).coefficients, x1)
    want = [jw.cwt(x1, scl_sig, jw.MorletWavelet(),
                   padding="periodic").coefficients]
    fam["cwt_signal_overlap_save"] = err(got, want)

    img = x.reshape(2, 16 * nd, -1)
    got = run(mesh_sig, lambda v: (
        sh.modwt2_sharded(v, w, 2, mesh_sig, row_axis="signal"),
        sh.imodwt2_sharded(
            sh.modwt2_sharded(v, w, 2, mesh_sig, row_axis="signal"),
            w, mesh_sig, row_axis="signal")), img)
    fam["modwt2_rows"] = err(got, [jw.modwt2(img, w, 2), img])

    # --- subtree families (single-gather inverses cross the boundary) ----
    got = run(mesh_scl, lambda v: (
        sh.wpt_sharded(v, sym8, 3, mesh_scl, packet_axis="scale"),
        sh.iwpt_sharded(
            sh.wpt_sharded(v, sym8, 3, mesh_scl, packet_axis="scale"),
            sym8, 3, mesh_scl, packet_axis="scale")), x)
    fam["wpt_subtree"] = err(got, [jw.wpt(x, sym8, 3), x])

    got = run(mesh_scl, lambda v: (
        sh.modwpt_sharded(v, w, 3, mesh_scl, node_axis="scale"),
        sh.imodwpt_sharded(
            sh.modwpt_sharded(v, w, 3, mesh_scl, node_axis="scale"),
            w, mesh_scl, node_axis="scale")), x)
    fam["modwpt_subtree"] = err(
        got, [jw.modwpt(x, w, 3, method="direct"), x])

    # --- scale/plane-sharded families (zero-comms + the ssq psum) --------
    scl = jw.generate_log_scales(1.0, 64.0, 2 * nd)
    got = run(mesh_scl, lambda v: sh.cwt_sharded(
        v, scl, jw.MorletWavelet(), mesh_scl).coefficients, x)
    fam["cwt_scales"] = err(
        got, [jw.cwt(jnp.asarray(x), scl, jw.MorletWavelet()).coefficients])

    img2 = rng.standard_normal((24, 32))
    scl2 = np.linspace(1.5, 9.0, nd)
    got = run(mesh_scl, lambda v: sh.cwt2_sharded(
        v, scl2, jw.MexicanHat2D(), mesh_scl).coefficients, img2)
    fam["cwt2_planes"] = err(
        got, [jw.cwt2(jnp.asarray(img2), scl2,
                      jw.MexicanHat2D()).coefficients])

    xf = x1[:1024].astype(np.float32)
    want_sc = jw.scattering1d(xf, j=4, q=2, oversampling=64)
    got = run(mesh_scl, lambda v: (
        (lambda r: (r.s0, r.s1, jnp.sum(r.s2), jnp.sum(r.s2 ** 2)))(
            sh.scattering_sharded(v, j=4, q=2, mesh=mesh_scl))), xf)
    fam["scattering_paths"] = err(got, [
        want_sc.s0, want_sc.s1, np.sum(np.asarray(want_sc.s2)),
        np.sum(np.asarray(want_sc.s2) ** 2)])

    imgf = rng.standard_normal((32, 32)).astype(np.float32)
    want_s2d = jw.scattering2d(imgf, j=2, l=4, oversampling=64)
    got = run(mesh_scl, lambda v: (
        (lambda r: (r.s0, r.s1, jnp.sum(r.s2), jnp.sum(r.s2 ** 2)))(
            sh.scattering2d_sharded(v, j=2, l=4, mesh=mesh_scl))), imgf)
    fam["scattering2d_paths"] = err(got, [
        want_s2d.s0, want_s2d.s1, np.sum(np.asarray(want_s2d.s2)),
        np.sum(np.asarray(want_s2d.s2) ** 2)])

    t = np.arange(512) / 512.0
    tone = np.sin(2 * np.pi * 40 * t).astype(np.float32)
    fc = float(jw.MorletWavelet().center_frequency)
    sscl = np.asarray(jw.generate_log_scales(fc / 160, fc / 10, 2 * nd))
    want_sq = jw.ssq_cwt(tone, sscl, sampling_rate=512.0)
    got = run(mesh_scl, lambda v: (
        (lambda r: (r.Tx, r.Wx))(
            sh.ssq_sharded(v, sscl, mesh=mesh_scl,
                           sampling_rate=512.0))), tone)
    # Elementwise Tx is NOT a robust cross-compilation invariant: a pure
    # tone's f32 instantaneous-frequency estimate sits on one bin edge at
    # EVERY time step, and the multi-process compilation's different fusion
    # rounding flips the whole ridge to the adjacent bin (measured: the
    # freq-marginal matches at 4e-8 while elementwise differs by the full
    # ridge mass).  Pin what IS invariant: Wx elementwise, the
    # freq-marginal Σ_l Tx (bin-assignment-independent — still catches any
    # psum/assembly bug), and the ridge landing within one bin of 40 Hz.
    wx_err = err(got[1:], [want_sq.Wx])
    marg_err = err([got[0].sum(-2)], [np.asarray(want_sq.Tx).sum(-2)])
    fam["ssq_psum"] = max(wx_err, marg_err)
    freqs = np.asarray(want_sq.ssq_freqs)
    ridge = freqs[np.argmax(np.abs(got[0][..., 64:-64]), axis=-2)]
    ratio = float(np.exp(np.max(np.abs(np.log(ridge / 40.0)))))
    bin_ratio = float(freqs[1] / freqs[0])
    fam["ssq_ridge_within_bin"] = 0.0 if ratio <= bin_ratio else ratio

    # --- batch-sharded 2D decorator analog -------------------------------
    imgs = rng.standard_normal((nd, 32, 32))
    got = run(mesh_dat, lambda v: sh.fwt2_sharded(v, w, mesh_dat), imgs)
    fam["fwt2_batch"] = err(got, [jw.fwt2(imgs, w)])

    return fam


#: per-family error tolerances for --full (f32 cascades are looser)
FULL_TOLS = {
    "scattering_paths": 2e-4, "scattering2d_paths": 2e-4,
    "ssq_psum": 2e-4, "ssq_ridge_within_bin": 0.5,
    "cwt_signal_overlap_save": 1e-6, "cwt_scales": 1e-6,
}
FULL_DEFAULT_TOL = 1e-8


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def launch(args) -> int:
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    procs = []
    for pid in range(args.num_processes):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={args.local_devices} "
            + env.get("XLA_FLAGS", ""))
        env.pop("JAX_PLATFORM_NAME", None)
        cmd = [sys.executable, __file__, "--worker",
               "--coordinator", coordinator,
               "--num-processes", str(args.num_processes),
               "--process-id", str(pid),
               "--local-devices", str(args.local_devices),
               "--n", str(args.n), "--batch", str(args.batch),
               "--level", str(args.level)]
        if args.full:
            cmd.append("--full")
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=str(REPO)))
    results, rc = [], 0
    for p in procs:
        try:
            out, err = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            rc = 2
        if p.returncode:
            rc = rc or p.returncode
        for line in out.splitlines():
            line = line.strip()
            if line.startswith("{"):
                results.append(json.loads(line))
        if p.returncode:
            sys.stderr.write(err[-20000:] + "\n")
    ok = rc == 0 and len(results) == args.num_processes and all(
        r["ok"] for r in results)
    print(json.dumps({
        "ok": ok, "num_processes": args.num_processes,
        "local_devices": args.local_devices,
        "global_devices": args.num_processes * args.local_devices,
        "results": results,
    }))
    return 0 if ok else (rc or 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--full", action="store_true",
                    help="run the whole parallel/sharded.py surface with "
                         "per-family parity asserts (VERDICT r3 #2)")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
