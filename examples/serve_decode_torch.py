"""Serving example: batched autoregressive decoding with the model's decode
caches through ``forward_decode``, the path the dry run's decode shapes
trace. Port of ``examples/serve_decode.py``, over
``repro_torch.launch.serve_decode``.

    PYTHONPATH=src python examples/serve_decode_torch.py --arch mixtral_8x22b

It uses the smoke config, as the reference's example does (the full
configs decode through ``python -m repro_torch.launch.serve_decode``), and
runs on the card unless ``--device cpu``.
"""
import argparse
import os
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def decode(cfg, batch: int = 4, prompt_len: int = 8, gen_len: int = 24, device="cpu",
           model=None, seed: int = 0) -> Dict:
    """Teacher-force a random prompt (from ``seed``) through the decode path
    and generate greedily; ``model`` (e.g. the reference's weights through
    ``checkpoint/convert.py``) or a model drawn from ``seed``. Returns
    ``launch.serve_decode.serve``'s result: the prompt, the logits at the
    prompt's positions, the generated tokens and tokens per second."""
    import torch

    from repro_torch.launch.serve_decode import serve

    return serve(cfg, batch, prompt_len, gen_len, torch.device(device), seed=seed, model=model)


def main(argv: Optional[List[str]] = None) -> Dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.train import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral_8x22b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    res = decode(cfg, args.batch, args.prompt_len, args.gen_len, device)
    gen = res["generated"]
    print(f"arch={cfg.name} batch={args.batch} generated={tuple(gen.shape)}")
    print(f"throughput: {res['tokens_per_s']:.1f} tokens/s ({device.type}, smoke cfg)")
    print("first sequence:", gen[0].reshape(-1)[:16].tolist())
    return res


if __name__ == "__main__":
    main()
