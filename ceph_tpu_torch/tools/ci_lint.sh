#!/bin/sh
# cephlint CI wrapper for the port: the two-speed gate, plus the smokes.
#
#   1. A fast --changed pass renders the diff's findings as SARIF so CI
#      can annotate the changed lines.
#   2. The sanitized codec fuzz (--san-smoke below).
#   3. A smoke-shape storage-path --profile run emits the per-stage
#      transfer ledger (h2d/d2h ops and bytes, library builds) as JSON
#      and FAILS on any steady-state library build.  It runs the `cuda`
#      plugin on the card; CEPHLINT_DEVICE=cpu runs it on the CPU.
#   4. The traced-op, qos-path, telemetry, repair-path and elastic-path
#      smokes, on the CPU, then the multichip dry run over two CPU slots.
#   5. The full-tree gate (the scan tests/test_torch_cephlint.py pins)
#      decides the exit code -- a finding anywhere fails CI, not just one
#      the diff happened to touch.
#
# Usage: ceph_tpu_torch/tools/ci_lint.sh [sarif-output-path]
#        ceph_tpu_torch/tools/ci_lint.sh --native-codec-smoke
#   builds the _wire_native codec extension from a clean build directory
#   and runs the codec interop round trip.
#        ceph_tpu_torch/tools/ci_lint.sh --san-smoke
#   builds the ASan/UBSan-instrumented codec twin and runs the
#   differential fuzzer (600 seeded cases) plus the repeated-pass leak
#   gate under the sanitizers.
#        ceph_tpu_torch/tools/ci_lint.sh --ring-smoke
#   runs the shared-memory frame ring smoke plus the ring-framing mutant
#   fuzz.
#        ceph_tpu_torch/tools/ci_lint.sh --elastic-smoke | --profile-smoke
#   runs ec_benchmark -w elastic-path / -w wire-tax at smoke shape.
# Each mode exits with its own status.
#   CEPHLINT_SARIF_OUT overrides the default cephlint.sarif.
#   CEPHLINT_NO_SMOKE=1 skips the smokes of steps 3 and 4 (lint-only
#   runners); CEPHLINT_NO_SAN=1 skips the sanitized codec fuzz.  A step
#   whose tool is missing fails: nothing is skipped unless asked.

set -eu

cd "$(dirname "$0")/../.."

require() {
    if ! command -v "$1" > /dev/null 2>&1; then
        echo "cephlint: $1 not found (needed by: $2)" >&2
        exit 1
    fi
}

require python "every step"

if [ "${1:-}" = "--native-codec-smoke" ]; then
    rm -rf ceph_tpu_torch/build/wire_native-*
    python -m ceph_tpu_torch.native.wire_codec --smoke > /dev/null
    echo "cephlint: native wire codec clean-build smoke passed" >&2
    exit 0
fi

if [ "${1:-}" = "--san-smoke" ]; then
    # the interpreter is uninstrumented, so libasan rides in via
    # LD_PRELOAD; leaks are gated by the fuzzer's repeated-pass gc/RSS
    # check, with a small quarantine so RSS stays an honest signal
    require "${CXX:-g++}" "the sanitized codec build"
    python -c 'from ceph_tpu_torch.native import build; build.wire_ext(san=True)'
    asan_lib="$(${CXX:-g++} -print-file-name=libasan.so)"
    if [ ! -e "$asan_lib" ]; then
        echo "cephlint: libasan.so not found (needed by --san-smoke)" >&2
        exit 1
    fi
    LD_PRELOAD="$asan_lib" \
    ASAN_OPTIONS="detect_leaks=0:quarantine_size_mb=8" \
    python -m ceph_tpu_torch.tools.wire_fuzz --san --cases 600 \
        --leak-passes 6 > /dev/null
    echo "cephlint: sanitized codec fuzz + leak gate passed" >&2
    exit 0
fi

if [ "${1:-}" = "--ring-smoke" ]; then
    python -m ceph_tpu_torch.msg.shm_ring --smoke > /dev/null
    python -m ceph_tpu_torch.tools.wire_fuzz --cases 14 --mutations 0 \
        --ring-cases 300 > /dev/null
    echo "cephlint: shm ring smoke + framing mutant fuzz passed" >&2
    exit 0
fi

if [ "${1:-}" = "--elastic-smoke" ]; then
    python -m ceph_tpu_torch.tools.ec_benchmark -w elastic-path --smoke \
        -P device=cpu > /dev/null
    echo "cephlint: elastic-path membership smoke passed" >&2
    exit 0
fi

if [ "${1:-}" = "--profile-smoke" ]; then
    python -m ceph_tpu_torch.tools.ec_benchmark -w wire-tax --smoke \
        -P device=cpu > /dev/null
    echo "cephlint: wire-tax profiler smoke passed" >&2
    exit 0
fi

out="${1:-${CEPHLINT_SARIF_OUT:-cephlint.sarif}}"

python ceph_tpu_torch/tools/cephlint.py --changed --format sarif > "$out"
echo "cephlint: wrote diff-scoped SARIF to $out" >&2

if [ "${CEPHLINT_NO_SAN:-}" != "1" ]; then
    sh ceph_tpu_torch/tools/ci_lint.sh --san-smoke
fi

if [ "${CEPHLINT_NO_SMOKE:-}" != "1" ]; then
    if [ "${CEPHLINT_DEVICE:-cuda}" = "cpu" ]; then
        storage_device="-P device=cpu"
    else
        storage_device=""
    fi
    # shellcheck disable=SC2086  # the -P pair splits on purpose
    python -m ceph_tpu_torch.tools.ec_benchmark --plugin cuda \
        -w storage-path -P k=4 -P m=2 $storage_device --objects 16 \
        --size 4096 --writers 4 --iterations 2 --profile
    echo "cephlint: storage-path transfer smoke passed" >&2
    python -m ceph_tpu_torch.osd.trace_bench --smoke --device cpu \
        > /dev/null
    echo "cephlint: traced-op observability smoke passed" >&2
    python -m ceph_tpu_torch.tools.ec_benchmark -w qos-path --smoke \
        -P device=cpu > /dev/null
    echo "cephlint: qos-path scale-harness smoke passed" >&2
    python -m ceph_tpu_torch.mgr.telemetry_bench --vstart-smoke \
        --device cpu > /dev/null
    echo "cephlint: wire-fed telemetry health smoke passed" >&2
    python -m ceph_tpu_torch.tools.ec_benchmark -w repair-path --smoke \
        -P device=cpu > /dev/null
    echo "cephlint: regenerating repair-path smoke passed" >&2
    sh ceph_tpu_torch/tools/ci_lint.sh --profile-smoke
    sh ceph_tpu_torch/tools/ci_lint.sh --elastic-smoke
    sh ceph_tpu_torch/tools/ci_lint.sh --ring-smoke
    sh ceph_tpu_torch/tools/ci_lint.sh --native-codec-smoke
    python -m ceph_tpu_torch.entry 2 --fast --device cpu
    echo "cephlint: multichip mesh-plane smoke passed (2 CPU slots)" >&2
fi

exec python ceph_tpu_torch/tools/cephlint.py
