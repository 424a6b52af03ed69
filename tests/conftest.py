"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``); sharding and mesh tests
use 8 virtual host devices.  The platform is also pinned in code, after
``import jax``, so a machine with a GPU still runs the suite on its CPU.
No test needs the GPU: the device path is plain JAX and runs here;
``python chip_smoke.py`` checks it on the card.  A card-only test would
carry the ``gpu`` marker and decide in a fixture, never at import time.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# no persistent compile cache for the suite: its xdist workers would race
# on the cache's unlocked entry files (utils/compile_cache.py)
os.environ["JAX_COMPILATION_CACHE_DIR"] = ""

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the rotavirus reference and its bwa-built index files, unpacked from
# fixtures/rotavirus.bwa.img by fixtures/extract_rotavirus.py
REFERENCE_RESOURCES = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures"
)

