"""Set-up shared by every test run from the repository's root: before any
test file is collected, the JAX package's native library (`libmrtpu.so`) is
brought up to date under one file lock.

Under pytest-xdist every worker collects every file, and
`tests/test_native.py` loads the library at collection through
`direct12pbrrenderer_tpu.native.load()`, which runs `make` when the library
is missing. Without this hook the workers of a fresh checkout each ran that
`make` at once, and a worker that loaded the library while another was still
writing it skipped the module. Each worker runs `pytest_configure` before it
collects, so here one process builds and the others wait for the lock and
find the library up to date. A failed build is left to `native.load()`,
which then returns None and the module skips as it did before.
"""

import fcntl
import pathlib
import subprocess

ROOT = pathlib.Path(__file__).resolve().parent
NATIVE = ROOT / "direct12pbrrenderer_tpu" / "native"


def pytest_configure(config):
    lock = ROOT / "build" / "native-make.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", str(NATIVE)], capture_output=True, timeout=300)
        except (subprocess.SubprocessError, OSError):
            pass
