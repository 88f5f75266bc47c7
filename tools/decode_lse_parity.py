"""``decode_attention``'s output bits at fixed shapes and seeds, for
whichever ``repro_torch`` is first on ``PYTHONPATH``, so that two
checkouts' kernels can be compared bit for bit on one card:

    PYTHONPATH=<checkout>/src python3 tools/decode_lse_parity.py --label B

Each case draws q and the caches from its seed on the card (bf16 and
fp32, the model's views of (B, S, KV, D) caches), runs the kernel without
the log-sum-exp and prints one JSON line: each case's SHA-256 of the
output's bytes. Where the checkout has ``return_lse``, the line also
says whether the output with it is the same bits.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json

import torch

from repro_torch.kernels import ops

# (B, KV, G, S, D, length): llama3.2-1b's serving shape and its rank's at
# model 2, granite-20b's rank over a sequence block, short and split
# fills, G 8 at D 128 and fp32's tiny shapes
CASES = ((4, 8, 4, 544, 64, 528), (4, 4, 4, 544, 64, 528),
         (4, 1, 48, 272, 128, 256), (4, 1, 48, 272, 128, 1),
         (4, 4, 8, 544, 128, 528), (2, 2, 4, 256, 64, 3),
         (1, 2, 2, 64, 32, 64), (2, 4, 1, 100, 96, 77))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    lse = "return_lse" in inspect.signature(ops.decode_attention).parameters
    digests, same = {}, True
    for i, (B, KV, G, S, D, n) in enumerate(CASES):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(i)
            q = torch.randn((B, 1, KV * G, D), generator=g,
                            device="cuda").to(dtype).view(B, KV, G, D)
            kc, vc = (torch.randn((B, S, KV, D), generator=g, device="cuda")
                      .to(dtype).permute(0, 2, 1, 3) for _ in range(2))
            o = ops.decode_attention(q, kc, vc, n)
            torch.cuda.synchronize()
            key = f"{(B, KV, G, S, D, n)} {str(dtype)[6:]}"
            digests[key] = hashlib.sha256(
                o.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()
            if lse:
                o2, _ = ops.decode_attention(q, kc, vc, n, return_lse=True)
                same &= torch.equal(o, o2)
    print(json.dumps({"label": args.label, "digests": digests,
                      "with_lse_same_bits": same if lse else None}))


if __name__ == "__main__":
    main()
