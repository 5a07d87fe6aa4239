"""Multi-PROCESS mesh execution (the multi-host story).

SURVEY.md §5 maps the reference's peer-copy multi-GPU intent
(src/cudaConvFFTDataStreams.cu:279-289) to "multi-host via the same
pjit/shard_map program across hosts with no code change". The single-process
8-virtual-device mesh tests cannot verify the cross-process half of that
claim (every device is addressable there); this test runs the library's
sharded paths under ``jax.distributed`` with 2 local processes × 4 CPU
devices each — half the 2×4 mesh is non-addressable from each process —
and cross-checks against single-device references. Verified result
(round 5): nothing changes — global ``device_put`` placement, the
shard_map executables, and the peaks head all run unmodified.
"""

import os
import subprocess
import sys

import pytest

_SCRIPT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "multiproc_dryrun.py"
)


@pytest.mark.skipif(
    sys.platform.startswith("win"), reason="POSIX subprocess harness"
)
def test_multiprocess_mesh_dryrun():
    env = dict(os.environ)
    # the workers force JAX_PLATFORMS=cpu themselves; scrub conftest's
    # in-process device-count flag so the parent env doesn't conflict
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, _SCRIPT],
        env=env,
        capture_output=True,
        text=True,
        timeout=540,
    )
    if proc.returncode != 0 and "UNAVAILABLE" in (
        proc.stdout + proc.stderr
    ):
        pytest.skip(
            "jax.distributed coordination unavailable in this sandbox"
        )
    assert proc.returncode == 0, (
        f"multiproc dryrun failed\nstdout:\n{proc.stdout[-2000:]}\n"
        f"stderr:\n{proc.stderr[-2000:]}"
    )
    assert "multiproc dryrun OK" in proc.stdout
