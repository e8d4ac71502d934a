"""Encode language instructions into per-task/variation feature tensors.

Counterpart of ``act3d_tpu/preprocessing/preprocess_instructions.py``
(reference data_preprocessing/preprocess_instructions.py:101-170): human
annotations (annotations.json) or RLBench's own descriptions, tokenised and
encoded with the CLIP text encoder (openai/clip-vit-base-patch32, max
length 53) or BERT, pickled as {task: {variation: (n_instr, 53, 512)
float32 numpy}}.

The encoder runs on the card (``--device cuda``, the default) or, when
asked, on the CPU (``--device cpu``); its features come back as float32
numpy either way.  Without an injected tokenizer and model, ``transformers``
loads the reference's published encoders (a download on first use).
RLBench's descriptions need the simulator.

Run:
  python -m act3d_tpu_torch.preprocessing.preprocess_instructions \\
      --tasks pick_and_lift --variations 0 \\
      --annotations annotations.json --output instructions.pkl [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import pickle
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device


def load_annotations(path) -> Dict[str, Dict[int, List[str]]]:
    """annotations.json rows -> task -> variation -> [instructions]
    (reference preprocess_instructions.py:60-99)."""
    with open(path) as f:
        data = json.load(f)
    items: Dict[str, Dict[int, List[str]]] = defaultdict(dict)
    for record in data:
        if isinstance(record, dict):
            task = record.get("task")
            variation = int(record.get("variation", 0))
            instrs = record.get("instructions") or [record.get("instruction")]
            if task is None:
                continue
            items[task].setdefault(variation, [])
            items[task][variation] += [i for i in instrs if i]
    return dict(items)


def encode_instructions(
    texts: List[str],
    encoder: str = "clip",
    max_length: int = 53,
    tokenizer=None,
    model=None,
    device="cuda",
) -> np.ndarray:
    """(n,) strings -> (n, max_length, 512) float32 numpy via the text
    encoder, run on ``device`` (the card unless the caller names the CPU;
    an injected model is moved there).

    ``tokenizer`` / ``model`` may be injected (a tokenizer callable
    returning ``{"input_ids": ...}`` and a module whose output has
    ``.last_hidden_state``); the default resolves the reference's
    published encoders."""
    dev = resolve_device(device)
    if tokenizer is not None and model is not None:
        pass
    elif encoder == "clip":
        from transformers import CLIPTextModel, CLIPTokenizer

        tokenizer = CLIPTokenizer.from_pretrained("openai/clip-vit-base-patch32")
        model = CLIPTextModel.from_pretrained("openai/clip-vit-base-patch32")
    elif encoder == "bert":
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained("bert-base-uncased")
        model = AutoModel.from_pretrained("bert-base-uncased")
    else:
        raise ValueError(f"unknown encoder {encoder}")

    tokenizer.model_max_length = max_length
    tokens = tokenizer(texts, padding="max_length")["input_ids"]
    lengths = [len(t) for t in tokens]
    if any(n > max_length for n in lengths):
        raise RuntimeError(f"Too long instructions: {lengths}")
    model = model.to(dev)
    with torch.no_grad():
        pred = model(torch.tensor(tokens, device=dev)).last_hidden_state
    return pred.float().cpu().numpy()


def synthetic_instructions(task: str, variation: int) -> Optional[List[str]]:
    """RLBench's own episode descriptions (needs the simulator).  As in JAX,
    the simulator-less ``RLBenchEnv`` raises ImportError here: the guarded
    import this function catches never fails."""
    try:
        from ..eval.rlbench_env import RLBenchEnv, task_file_to_task_class
    except ImportError:
        return None
    env = RLBenchEnv(data_path="", headless=True)
    task_inst = env.env.get_task(task_file_to_task_class(task))._task
    task_inst.init_task()
    for _ in range(3):
        try:
            return task_inst.init_episode(variation)
        except Exception:
            continue
    return None


def main(argv=None, tokenizer=None, model=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--variations", nargs="*", type=int, default=[0])
    p.add_argument("--annotations", default=None)
    p.add_argument("--encoder", default="clip", choices=["clip", "bert"])
    p.add_argument("--model_max_length", type=int, default=53)
    p.add_argument("--output", required=True)
    p.add_argument("--zero", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the text encoder runs: cuda (default) or cpu")
    args = p.parse_args(argv)

    annotations = load_annotations(args.annotations) if args.annotations else {}
    instructions: Dict[str, Dict[int, np.ndarray]] = {}
    for task, variation in itertools.product(args.tasks, args.variations):
        instr = annotations.get(task, {}).get(variation)
        if instr is None:
            instr = synthetic_instructions(task, variation)
        if instr is None:
            raise RuntimeError(
                f"No instructions for {task}+{variation}: provide "
                "--annotations or install the RLBench simulator stack"
            )
        feats = encode_instructions(
            instr, args.encoder, args.model_max_length,
            tokenizer=tokenizer, model=model, device=args.device,
        )
        if args.zero:
            feats = np.zeros_like(feats)
        instructions.setdefault(task, {})[variation] = feats

    print("Instructions:", sum(len(v) for v in instructions.values()))
    out = Path(args.output)
    out.parent.mkdir(exist_ok=True, parents=True)
    with open(out, "wb") as f:
        pickle.dump(instructions, f)


if __name__ == "__main__":
    main()
