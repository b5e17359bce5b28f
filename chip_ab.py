"""Times the grouped-FFN kernels of several checkouts of this repo against
each other on one card: K3 (``grouped_ffn_ragged``), K7
(``grouped_ffn_ragged_quant``) and, where the checkout has it, K6
(``grouped_ffn``), at ``chip_smoke.py``'s shapes.

    python3 chip_ab.py ROOT [ROOT ...]

For each ROOT, in the order given (to compare two commits, give the parent
and the change as ``parent change change parent``), a child process
imports ROOT's ``chip_smoke.py``, which builds ROOT's kernels from ROOT's
own sources, and runs its K3, K7 and K6 checks on the same seeded inputs:
the staged 2x2 plan's rank-0 buffer, the pipelined int8 plan's chunk and
the einsum phase's [64, 128, 1024] buffer of full-width gpt3_medium_moe.  Each run prints one JSON line with the root,
the card (``nvidia-smi``'s name and power limit) and each check's kernel,
plain and bound times and its error against the plain version.  Exits
non-zero if there is no card or any check fails.
"""

import os
import subprocess
import sys

CHILD = r"""
import json, os, sys, time
root = os.getcwd()
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from repro_torch.configs.base import get_config
from repro_torch.models import model as model_lib

torch.backends.cuda.matmul.allow_tf32 = False
arch = get_config(cs.ARCH_ID)
ctx = model_lib.build_ctx(arch, device="cuda", use_flash=True,
                          aux_mode="none", seq_len=cs.CACHE_LEN,
                          global_batch=cs.NUM_SLOTS)
params = model_lib.init_params(
    ctx, torch.Generator(device="cuda").manual_seed(0))
gen = torch.Generator(device="cuda").manual_seed(1)
t0 = time.time()
with torch.no_grad():
    k3 = cs.check_k3(torch, cs.staged_case(torch, params, arch, gen))
    k7 = cs.check_k7(torch, cs.pipelined_case(torch, params, arch, gen))
    k6 = None
    if hasattr(cs, "check_k6"):
        x6, w_in6, w_out6, filled = cs.einsum_k6_case(torch, params, arch,
                                                      gen)
        k6 = cs.check_k6(torch, x6, w_in6, None, w_out6, "einsum", filled)
keys = ("ms", "plain_ms", "bound_ms", "max_abs_err")
out = {"root": root, "nvidia_smi": cs.nvidia_smi_line(),
       "seconds": time.time() - t0, "K3": {k: k3[k] for k in keys},
       "K7": {k: k7[k] for k in keys + ("quantize_ms",)}}
if k6 is not None:
    out["K6"] = {k: k6[k] for k in keys + ("bmm_chain_ms",)}
print(json.dumps(out), flush=True)
"""


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        if not os.path.exists(os.path.join(root, "chip_smoke.py")):
            print(f"chip_ab: {root} holds no chip_smoke.py", file=sys.stderr)
            return 2
        proc = subprocess.run([sys.executable, "-c", CHILD],
                              cwd=os.path.abspath(root),
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stderr[-4000:])
            print(f"chip_ab: the run in {root} failed (exit "
                  f"{proc.returncode})", file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
