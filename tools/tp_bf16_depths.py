"""How far two ranks' bf16 logits lie from one process's, and both from
the fp32 function of the same bf16 weights, by depth: mamba2-130m at 2,
4, 8 and 24 layers and jamba-v0.1-52b's period (8 layers) and two cut
periods (2 layers at ``attn_period`` 2: a mamba and an attention + MoE
sub-layer; 4 at ``attn_period`` 4), or with ``--vlm-encdec``
whisper-medium at 2, 4, 8 and 24 encoder and decoder layers and
qwen2-vl-7b at 2 and 4 layers, full width, on a (1, 2) mesh of two
ranks sharing the card over gloo. It runs ``chip_smoke.py``'s own
tensor-parallel functions (weights from its TP_SEED, its prompts: 4 x
512 tokens or patch embeddings, whisper's 1500 frames beside a 64-token
decoder prompt; 32 decode steps teacher-forced with the one-process
run's tokens, an MoE replayed on the ranks' routes):

    PYTHONPATH=src python3 tools/tp_bf16_depths.py [--cpu] [--vlm-encdec]

``--cpu`` runs the tiny configs on the host at prompt 32 (a rehearsal).
Prints one line a run: the ranks against one process, one process and
the ranks against the fp32 function (each the largest |diff| of a logit
row over that row's largest |logit|), the ranks' launches and times, an
MoE's router rows that differ.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path[:0] = [os.getcwd()]
import chip_smoke as C  # noqa: E402


def runs(cpu: bool, vlm_encdec: bool) -> list:
    """(arch, depth, bf16 config) of each run."""
    def bf16(arch):
        cfg = C.get_config(arch)
        if cpu:
            cfg = C.tiny_version(cfg).with_(ssm_chunk=32)
        return cfg.with_(param_dtype=torch.bfloat16,
                         compute_dtype=torch.bfloat16)
    if vlm_encdec:
        whisper, qwen = bf16(C.ENCDEC_ARCH), bf16(C.VLM_ARCH)
        return ([(C.ENCDEC_ARCH, n, whisper.with_(n_enc_layers=n,
                                                  n_dec_layers=n))
                 for n in ((2,) if cpu else (2, 4, 8, 24))]
                + [(C.VLM_ARCH, n, qwen.with_(n_layers=n)) for n in (2, 4)])
    mamba, jamba = bf16("mamba2-130m"), bf16("jamba-v0.1-52b")
    depths = (2, 4) if cpu else (2, 4, 8, 24)
    return ([("mamba2-130m", n, mamba.with_(n_layers=n)) for n in depths]
            + [("jamba-v0.1-52b", f"{n}/{p}", jamba.with_(
                n_layers=n, attn_period=p)) for n, p in ((2, 2), (4, 4),
                                                         (8, 8))])


def main() -> None:
    cpu = "--cpu" in sys.argv
    dev = torch.device("cpu" if cpu else "cuda")
    if cpu:
        C.LM_PROMPT, C.LM_BATCH, C.TP_GEN = 32, 2, 5
        C.WHISPER_FRAMES, C.WHISPER_PROMPT = 24, 8
    else:
        C.phase_device()
        C.phase_build()
    todo = runs(cpu, "--vlm-encdec" in sys.argv)
    refs, args = [], []
    for _, _, cfg in todo:
        ref, run = C.tp_reference(cfg, dev)
        refs.append(ref)
        args.append(((1, 2), (*run, cfg.family == C.SSM_TP_DRAW_IN_TURN)))
    ranks = C.spawn_ranks(C.tp_rank, 2, dev.type, args)
    for k, ((arch, depth, cfg), ref) in enumerate(zip(todo, refs)):
        got = [r[1][k] for r in ranks]
        tp = C.tp_logits(got, (1, 2))
        one, exact = C.replayed_logits(arch, cfg, got, ref, dev, exact=True)
        layers = (f"{depth} encoder and {depth} decoder"
                  if cfg.family == "encdec" else depth)
        line = (f"{arch} at {layers} layers, bf16: the ranks against one "
                f"process {C.row_rel(tp, one):.4e}; against the fp32 "
                f"function one process {C.row_rel(one, exact):.4e}, the "
                f"ranks {C.row_rel(tp, exact):.4e}; launches per rank "
                f"{got[0]['launches']}; prefill {got[0]['prefill_ms']:.1f} "
                f"ms, decode {got[0]['decode_ms']:.1f} ms/token")
        if cfg.n_experts:
            n_rows, n_diff, _ = C.route_divergence(
                got[0]["routes"], ref["routes"],
                C.expected_launches(cfg, 0)[4], C.LM_BATCH, C.LM_PROMPT)
            line += f"; router rows differing {n_diff} of {n_rows}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
