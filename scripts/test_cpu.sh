#!/bin/sh
# Run the test suite on a virtual 8-device CPU mesh (fast local compiles,
# exercises the distributed code paths).
# ulimit -s: XLA's CPU compiler can overflow the default 8 MB stack when
# compiling deeply nested while_loop programs late in a long pytest
# process (observed as a segfault in backend_compile); raise it.
ulimit -s 65536 2>/dev/null || true
exec env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python -m pytest "${@:-tests/}" -q
