"""How many small symmetric matrices one batched ``torch.linalg.eigh`` call
takes on the card.

    python scripts/probe_eigh_batch.py

The pose solver's DLT (``fast3r_torch/ops/pnp.py`` ``_dlt_pose``) takes the
smallest eigenvector of a 12x12 normal matrix per hypothesis, and the
"individual" focal search batches 100 focals x 32 hypotheses a view.  This
prints, for batches of 12x12 matrices from 512 to 65,536, whether cuSOLVER
took the call; ``ops.pnp.EIGH_BATCH`` stays below the first batch it turns
down.  Prints the card's name and the CUDA version first; needs a GPU.
"""

import subprocess
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_eigh_batch: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          torch.version.cuda)
    g = torch.Generator(device="cuda").manual_seed(0)
    for b in (512, 1024, 4096, 16384, 32767, 32768, 65536):
        a = torch.randn(b, 24, 12, device="cuda", generator=g)
        try:
            torch.linalg.eigh(a.transpose(-1, -2) @ a)
            torch.cuda.synchronize()
            print(b, "ok")
        except RuntimeError as e:
            print(b, "refused:", str(e).splitlines()[0][:120])
    return 0


if __name__ == "__main__":
    sys.exit(main())
