"""Batched greedy decoding through ``forward_decode``, with the model's
decode caches (a KV cache per GQA layer, the latent and roped-key caches of
an MLA layer, the recurrent state of a Mamba, mLSTM or sLSTM layer). Port
of ``examples/serve_decode.py``. It decodes every catalog config. With K
codebooks (``musicgen_large``) each token is (B, 1, K) and every codebook
is generated greedily at each step (``argmax`` over the last axis of the
(B, 1, K, V) logits), as the reference does. Decoding takes no frontend
prefix, as the reference's ``forward_decode`` takes none.

    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch qwen3_0_6b
    PYTHONPATH=src python -m repro_torch.launch.serve_decode \\
        --arch phi4_mini_3_8b_swa --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_decode \\
        --arch deepseek_v2_236b --smoke --device cpu

Draws the model from ``--seed`` (random weights: nothing is downloaded) and
a random prompt of ``--prompt-len`` tokens for each of ``--batch``
sequences, teacher-forces the prompt through the decode path one token at a
time, then generates greedily until each sequence holds ``--prompt-len +
--gen-len - 1`` tokens. The model runs in its config's compute dtype on
float32 masters, as in training. It runs the full config on the card; the
reduced one with ``--smoke``, and on the CPU with ``--device cpu``. Prints
the generation's tokens per second.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen_len: int,
          device: torch.device, seed: int = 0, model=None) -> Dict:
    """Prefill ``prompt_len`` random tokens, then generate. ``model``, if
    given, is a built model of ``cfg``'s leaves, run under ``cfg`` (its
    compute dtype, its MoE capacity): one draw of the weights then serves
    several runs. Returns the model, the prompt (B, prompt_len) or (B,
    prompt_len, K), the logits at the prompt's positions, the generated
    tokens (B, gen_len) or (B, gen_len, K) and the generation's tokens per
    second."""
    from repro_torch.models import forward_decode, init_cache, init_model, use_config

    cfg = cfg.replace(scan_layers=False)
    model = init_model(cfg, seed=seed, device=device) if model is None else use_config(model, cfg)
    cfg = model.cfg  # a given model keeps its own layout
    K = cfg.num_codebooks
    tok_shape = (batch, 1, K) if K > 1 else (batch, 1)
    rng = np.random.RandomState(seed)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(batch, prompt_len)
                                          + ((K,) if K > 1 else ())))
    prompt = prompt.to(device=device, dtype=torch.int64)
    max_len = prompt_len + gen_len
    cache = init_cache(cfg, batch, max_len, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        prompt_logits = []
        for t in range(prompt_len):  # prefill by teacher forcing
            logits, cache = forward_decode(model, prompt[:, t: t + 1], cache, t)
            prompt_logits.append(logits[:, 0])
        # greedy over the last axis: every codebook's next token at once
        tok = logits[:, -1].argmax(dim=-1).reshape(tok_shape)
        out: List[torch.Tensor] = [tok]
        sync()
        t0 = time.perf_counter()
        for t in range(prompt_len, max_len - 1):
            logits, cache = forward_decode(model, tok, cache, t)
            tok = logits[:, -1].argmax(dim=-1).reshape(tok_shape)
            out.append(tok)
        sync()
        seconds = time.perf_counter() - t0
    return {"model": model, "prompt": prompt, "prompt_logits": torch.stack(prompt_logits, 1),
            "generated": torch.cat(out, 1), "seconds": seconds,
            "tokens_per_s": batch * (len(out) - 1) / seconds}


def main(argv: Optional[List[str]] = None) -> Dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.train import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, args.batch, args.prompt_len, args.gen_len, device, seed=args.seed)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"arch={cfg.name} dtype={cfg.dtype} batch={args.batch} "
          f"generated={tuple(res['generated'].shape)}")
    print(f"throughput: {res['tokens_per_s']:.1f} tokens/s ({where})")
    print("first sequence:", res["generated"][0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
