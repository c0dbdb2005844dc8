#!/bin/sh
# compute-sanitizer's memcheck, initcheck and racecheck over the card tests
# that launch K1, K1's fixed walk and K2b (at the tests' sizes), one log
# each under the output directory (default build/sanitizer). Run from the
# repository root on the GPU machine:
#
#     sh scripts/torch_sanitize.sh [seconds a tool, default 420] [output directory]
#
# First a probe: if the sanitizer cannot run a CUDA program here, it says so
# and stops with the probe's exit code.
limit=${1:-420}
san=${COMPUTE_SANITIZER:-/usr/local/cuda/bin/compute-sanitizer}
out=${2:-build/sanitizer}
mkdir -p "$out"
"$san" --version || exit $?
timeout 180 "$san" --tool memcheck --log-file "$out/probe.log" python3 -c \
    "import torch; x = torch.arange(8, device='cuda'); print('probe', int(x.sum()))"
rc=$?
cat "$out/probe.log"
if [ $rc -ne 0 ]; then
    echo "sanitizer probe: exit code $rc"
    exit $rc
fi
for tool in memcheck initcheck racecheck; do
    start=$(date +%s)
    timeout "$limit" "$san" --tool "$tool" --log-file "$out/$tool.log" \
        python3 -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q -p no:cacheprovider \
        -k "K1 or fixed or K2b" > "$out/$tool.pytest.log" 2>&1
    echo "$tool: exit code $?, $(( $(date +%s) - start )) s; $(tail -n 1 "$out/$tool.pytest.log")"
    grep -E "ERROR SUMMARY|========= (Invalid|Uninitialized|Race|Error)" "$out/$tool.log" | sort | uniq -c | head -n 20
done
