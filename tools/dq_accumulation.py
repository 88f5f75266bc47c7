"""Why ``dequant_matmul`` sends D <= 64 to the CUDA cores.

The tensor cores' fp32 accumulation is not IEEE round-to-nearest, so the
tensor route's sum of a k-tile can miss the plain version's by more than
rtol/atol 1e-5 near zero (``csrc/dequant_matmul.cu``). At bench_roofline's
D 64 shapes with phase 17's operands (x ~ N(0, 1), q uniform over the int8
range, per-channel scales in [0.01, 0.1]) this launches the tensor route
directly (route 1 of the kernel's C interface; the wrapper takes the CUDA
cores there) and the wrapper's own call, on the card:

    PYTHONPATH=src python3 tools/dq_accumulation.py

For each shape it prints each call's largest error as a share of rtol/atol
1e-5 of the plain version (over 1 fails that check), then the card's name
and power limit, then one JSON line.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.dequant_matmul import _library, dequant_matmul_ref

SHAPES = ((1024, 64, 256), (64, 64, 512))        # one k-tile


def tensor_route(x, q, s) -> torch.Tensor:
    """One tensor-route launch, 64 rows a block."""
    B, D = x.shape
    N = q.shape[1]
    y = torch.empty((B, N), device=x.device)
    rc = _library().dequant_matmul_f32(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), B, D, N, 1,
        64, 128, int(s.dim() == 1),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"launch failed ({rc})")
    return y


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, D, N in SHAPES:
        x = torch.randn((B, D), generator=g, device="cuda")
        q = torch.randint(-127, 128, (D, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = 0.01 + 0.09 * torch.rand((N,), generator=g, device="cuda")
        ref = dequant_matmul_ref(x, q, s)
        shares = {}
        for name, y in (("tensor", tensor_route(x, q, s)),
                        ("wrapper", ops.dequant_matmul(x, q, s))):
            torch.cuda.synchronize()
            shares[name] = float(((y - ref).abs() / (1e-5 + 1e-5 * ref.abs()))
                                 .max())
        rows.append(dict(shape=[B, D, N], **shares))
        print(f"({B}, {D}, {N}) vs plain, share of rtol/atol 1e-5: tensor "
              f"route {shares['tensor']:.3f}, the wrapper's route "
              f"{shares['wrapper']:.3f}")
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "d64_vs_plain": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
