"""Generator data-efficiency sweep (thesis §4.2.3 / Fig 4.4a protocol),
ported from ``scripts/demo_data_efficiency.py``: train the program generator
on increasing question counts and report held-out program exact match per
size, on a synthetic templated corpus.

The JAX script's hand-written optax loop is a torch Adam loop here with the
same learning rate (2e-3, no clipping), batch (64) and steps (300), over
:func:`~explainable_spatial_vqa_tpu_torch.evalsuite.data_efficiency_sweep`.
Env knob: DEMO_DEVICE (default cuda).

    python -m explainable_spatial_vqa_tpu_torch.demos.data_efficiency
"""

from __future__ import annotations

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
from explainable_spatial_vqa_tpu_torch.core import vocab as voc
from explainable_spatial_vqa_tpu_torch.core.artifacts import encode_questions
from explainable_spatial_vqa_tpu_torch.core.config import GeneratorConfig, OptimConfig
from explainable_spatial_vqa_tpu_torch.demos.common import demo_device
from explainable_spatial_vqa_tpu_torch.evalsuite import data_efficiency_sweep
from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
from explainable_spatial_vqa_tpu_torch.train.losses import cross_entropy
from explainable_spatial_vqa_tpu_torch.train.trainer import build_optimizer

STEPS = 300
BATCH = 64
LEARNING_RATE = 2e-3


def main() -> None:
    device = demo_device()
    _, questions = syn.synthesize_dataset(150, 5, seed=9)
    vocab = voc.build_clevr_vocab([questions])
    enc = encode_questions(questions, vocab)
    q_all, p_all = enc.questions, enc.programs
    n_eval = 150
    q_eval, p_eval = q_all[-n_eval:], p_all[-n_eval:]
    q_pool, p_pool = q_all[:-n_eval], p_all[:-n_eval]

    def train_at(fraction: float) -> float:
        n = max(int(len(q_pool) * fraction), 16)
        q = torch.as_tensor(q_pool[:n], device=device)
        p = torch.as_tensor(p_pool[:n], device=device)
        cfg = GeneratorConfig(
            vocab_size=int(q_all.max()) + 1, program_vocab_size=int(p_all.max()) + 1,
            embed_dim=48, hidden_dim=96, encoder_layers=1, decoder_layers=1,
            dropout=0.0, program_len=p_all.shape[1],
        )
        model = init_parameters(ProgramGenerator(cfg, torch.float32, device), seed=0)
        model.eval()  # deterministic: no dropout, every coin teacher-forced
        optimizer, _ = build_optimizer(list(model.parameters()),
                                       OptimConfig(learning_rate=LEARNING_RATE))
        rng = np.random.RandomState(0)
        for _ in range(STEPS):
            idx = torch.as_tensor(rng.choice(n, min(BATCH, n), replace=False), device=device)
            qb, pb = q[idx], p[idx]
            loss = cross_entropy(model(qb, pb, teacher_forcing=1.0)["logits"], pb)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        with torch.no_grad():
            gen = model.generate(torch.as_tensor(q_eval, device=device)).cpu().numpy()
        em = 0
        for i in range(len(p_eval)):
            end = (np.argmax(p_eval[i] == 2) + 1) if (p_eval[i] == 2).any() else len(p_eval[i])
            em += int((gen[i][:end] == p_eval[i][:end]).all())
        acc = em / len(p_eval)
        print(f"  {n} training questions -> held-out program EM {acc:.3f}", flush=True)
        return acc

    print("generator data-efficiency sweep (held-out EM by train size):")
    results = data_efficiency_sweep(train_at, fractions=(0.1, 0.3, 1.0))
    print({f"{k:.1f}": round(v, 3) for k, v in results.items()})


if __name__ == "__main__":
    main()
