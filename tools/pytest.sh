#!/bin/bash
# CPU test run: JAX on the host CPU with 8 virtual devices for the mesh
# tests (tests/conftest.py sets the same).
cd "$(dirname "$0")/.." || exit 1
exec env JAX_PLATFORMS=cpu \
  XLA_FLAGS="--xla_force_host_platform_device_count=8" \
  python -m pytest "$@"
