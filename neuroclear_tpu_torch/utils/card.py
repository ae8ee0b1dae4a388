"""What the measurement tools (``scripts/count_step_flops``, ``mem_study``,
``profile_inference``, ``bench_conv_kernels``) share: the device they run
on, the card's name and power limit as ``nvidia-smi`` gives them, TF32 off,
and times on the card's clock."""

from __future__ import annotations

import subprocess

import torch

from .. import resolve_device


def tool_device(tool: str, device=None) -> torch.device:
    """``device`` (the card when None) for the tool ``tool``; without a card
    and without ``--device cpu`` it exits nonzero with a message, never
    falling back to the CPU."""
    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{tool}: {e}")


def no_tf32() -> None:
    """f32 convs and products in full f32 (no TF32), as the JAX package's
    HIGHEST precision and the smoke run them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def card_line(dev: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card (the name alone, and why, where nvidia-smi does not
    answer); "cpu" for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name(dev)}, power limit not read ({e})"


def cuda_seconds(fn, dev: torch.device) -> float:
    """Seconds of ``fn()`` on the card's clock: CUDA events on the current
    stream around it, then a synchronisation."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        start.record()
        fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3
