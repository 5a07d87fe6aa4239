#!/usr/bin/env python
"""Multi-PROCESS mesh dryrun — verifies the multi-host story SURVEY.md §5
claims ("multi-host via the same pjit/shard_map program across hosts with no
code change") that the single-process 8-virtual-device tests never touch.
It forces JAX onto the CPU, so it never opens a GPU.

Runs the library's sharded paths over ``jax.distributed`` with 2 local
processes × 4 CPU devices each (one global 2×4 mesh, half of it
NON-ADDRESSABLE from each process — the property that distinguishes
multi-host from single-process multi-device):

  - DP×TP training step (models.train_step) with global shardings,
  - conv_spectral_sharded (bank sharded over the kernel axis, spectra
    replicated via their PartitionSpec),
  - detect_peaks_sharded (per-device peaks, no collectives),

each cross-checked against a single-device reference computed from the
same seeded inputs, gathered with ``multihost_utils.process_allgather``.

Usage: ``python tests/multiproc_dryrun.py`` (parent: spawns the two
worker processes and reports); workers are invoked with ``--proc I``.
CI-runnable on CPU; tests/test_multiprocess.py wraps it (skipped where
subprocess spawn is unavailable)."""
import os
import subprocess
import sys


def worker(proc_id: int, num_procs: int, port: int) -> None:
    # env must be set before jax imports (done in __main__ for workers)
    import jax

    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=num_procs,
        process_id=proc_id,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    import cuda_fft_convolution_tpu as fc
    from cuda_fft_convolution_tpu.models import (
        FilterBankDetector,
        detect_peaks,
        init_detector,
        train_step,
    )

    assert jax.process_count() == num_procs, jax.process_count()
    assert len(jax.devices()) == 4 * num_procs, len(jax.devices())
    assert len(jax.local_devices()) == 4
    d_ax, k_ax = 2, (4 * num_procs) // 2
    mesh = fc.make_mesh(data=d_ax, kernels=k_ax)

    rng = np.random.default_rng(0)
    batch, feat, h, w = 2 * d_ax, 2, 16, 16
    n_filters, kh, kw = 2 * k_ax, 4, 4

    # --- DP×TP train step with GLOBAL shardings (host arrays are the
    # same in every process; device_put scatters each process's
    # addressable shards — the multi-host placement path).
    import optax

    model = init_detector(jax.random.key(0), n_filters, feat, kh, kw)
    images = rng.standard_normal((batch, feat, h, w)).astype(np.float32)
    targets = rng.standard_normal(
        (batch, n_filters, h, w)
    ).astype(np.float32)
    tx = optax.sgd(1e-2)
    opt_state = tx.init(model)
    model_sharding = FilterBankDetector(
        kernels=NamedSharding(mesh, P("kernels", None, None, None)),
        bias=NamedSharding(mesh, P("kernels")),
    )
    model_g = jax.device_put(model, model_sharding)
    images_g = jax.device_put(
        images, NamedSharding(mesh, P("data", None, None, None))
    )
    targets_g = jax.device_put(
        targets, NamedSharding(mesh, P("data", "kernels", None, None))
    )
    step = jax.jit(lambda m, o, x, y: train_step(m, o, x, y, tx))
    new_model, _, loss = step(model_g, opt_state, images_g, targets_g)
    loss = float(loss)  # scalar: fully replicated, fetchable anywhere
    assert np.isfinite(loss), loss
    jax.block_until_ready(new_model)

    # --- sharded bank convolution; spectra staged per-process from the
    # same host inputs, then placed to the global mesh by the library.
    data = rng.standard_normal((2 * d_ax, 12, 12, feat)).astype(np.float32)
    kerns = [
        rng.standard_normal((3, 3, feat)).astype(np.float32)
        for _ in range(2 * k_ax + 1)  # non-divisible bank on purpose
    ]
    sd = fc.fft_data(data, 3, 3)
    out = fc.conv_spectral_sharded(sd, kerns, mesh)
    out_host = multihost_utils.process_allgather(out, tiled=True)
    want = fc.conv_spectral(sd, kerns)  # local single-device reference
    np.testing.assert_allclose(
        np.asarray(out_host), np.asarray(want), atol=1e-5
    )

    # --- sharded detection head
    sdp = fc.fft_data_tiled(
        data, 3, 3, block_h=16, block_w=16, trim_mode="same",
        trim_kernel_h=3, trim_kernel_w=3,
    )
    pv, pp = fc.detect_peaks_sharded(sdp, jnp.stack(kerns), mesh)
    pp_host = multihost_utils.process_allgather(pp, tiled=True)
    wv, wp = detect_peaks(sdp, jnp.stack(kerns), mode="same")
    np.testing.assert_array_equal(np.asarray(pp_host), np.asarray(wp))

    multihost_utils.sync_global_devices("dryrun-done")
    if proc_id == 0:
        print(
            f"multiproc dryrun OK: {num_procs} processes x 4 devices, "
            f"mesh {d_ax}x{k_ax}, train loss {loss:.6f}, "
            f"sharded conv {out_host.shape}, sharded peaks "
            f"{pp_host.shape}",
            flush=True,
        )
    jax.distributed.shutdown()


def main() -> int:
    import socket

    num_procs = 2
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
        XLA_FLAGS=(
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4"
        ),
        FFTCONV_MULTIPROC_PORT=str(port),
        FFTCONV_MULTIPROC_N=str(num_procs),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--proc", str(i)],
            env=env,
        )
        for i in range(num_procs)
    ]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        # a hung/failed worker must not orphan its sibling holding the
        # coordinator port (the pytest wrapper kills only this parent)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        print(f"FAILED: worker return codes {rcs}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    if "--proc" in sys.argv:
        # worker: the parent already set JAX_PLATFORMS/XLA_FLAGS env
        pid = int(sys.argv[sys.argv.index("--proc") + 1])
        worker(
            pid,
            int(os.environ["FFTCONV_MULTIPROC_N"]),
            int(os.environ["FFTCONV_MULTIPROC_PORT"]),
        )
    else:
        sys.exit(main())
