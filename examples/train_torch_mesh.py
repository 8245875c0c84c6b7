"""The PyTorch port on a mesh of processes, one device each.

Every process builds the same model from the same seed and passes the
same global batches; ``Trainer`` places the model on a ``DeviceMesh`` of
the spec's axes (data: gradient averaging; fsdp: FSDP2; tensor: DTensor
column / row parallel layers) and copies only this rank's rows to its
device. With ``--ckpt-dir`` each process writes its shard of the
checkpoint, and a rerun under another spec resumes from it.

Run on the CPU (gloo)::

    torchrun --nproc_per_node=2 examples/train_torch_mesh.py \\
        --spec fsdp=2 --device cpu --steps 10

and on cards (NCCL, one card a process, ``cuda:LOCAL_RANK``)::

    torchrun --nproc_per_node=4 examples/train_torch_mesh.py \\
        --spec data=2,tensor=2 --model llama --steps 10
"""

import argparse

import numpy as np
import torch

from dlrover_tpu_torch.accel import ParallelSpec
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.train.trainer import LoggingCallback, Trainer


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--spec", default="fsdp=2",
                        help="degrees, e.g. data=2,fsdp=2 (their product is "
                             "the number of processes)")
    parser.add_argument("--model", choices=("gpt", "llama"), default="gpt")
    parser.add_argument("--device", default=None,
                        help="cpu for gloo; default: this worker's card")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=32)
    parser.add_argument("--ckpt-dir", default="")
    args = parser.parse_args()

    spec = ParallelSpec(**{k: int(v) for k, v in
                           (kv.split("=") for kv in args.spec.split(","))})
    device = args.device or ("cuda" if torch.cuda.is_available() else None)
    if device == "cuda":
        device = None  # this worker's card, cuda:LOCAL_RANK
    model = (GPT(GPTConfig.tiny(), device=device) if args.model == "gpt"
             else Llama(LlamaConfig.tiny(), device=device))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (args.batch, args.seq))
               for _ in range(args.steps)]
    trainer = Trainer(model, adamw(1e-3), lambda m, p, b: loss_fn(m(b), b),
                      batches[0], spec=spec, device=device,
                      checkpoint_dir=args.ckpt_dir, persist_every=5,
                      callbacks=[LoggingCallback(every=1)])
    out = trainer.fit(iter(batches), steps=args.steps)
    trainer.close()
    print(f"done: step {out['step']}, loss {out['loss']:.5f}", flush=True)


if __name__ == "__main__":
    main()
