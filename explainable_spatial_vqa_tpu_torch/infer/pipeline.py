"""Full inference pipeline: question -> program -> chained execution -> answer,
ported from ``explainable_spatial_vqa_tpu/infer/pipeline.py``.

1. the Program Generator greedily decodes fused program tokens (postfix);
2. decoded programs are parsed back to node lists and compiled to
   :class:`ChainArrays` (function ids in the executor's vocabulary, dependency
   indices from the postfix structure);
3. the :class:`ExecutorChainRunner` executes the chains: ``"sorted"`` (the
   default, as in the JAX package): depth-sorted batches that each stop at
   their deepest chain; ``"bucketed"``: one batch per depth bucket;
   ``"pool"``: the continuous-batching slot pool; ``"plain"``: every step
   position over the whole batch.  All four give the same answers;
4. the final step's token is the answer; with ground truth given, the
   faithfulness tally compares (program, answer) correctness jointly.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.core import programs as prog
from explainable_spatial_vqa_tpu_torch.core.tokenizer import END, NULL, START
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.evalsuite.faithfulness import (
    FaithfulnessTally,
    tally_faithfulness,
)
from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
from explainable_spatial_vqa_tpu_torch.models.layers import Device
from explainable_spatial_vqa_tpu_torch.train.datasets import ChainArrays

logger = logging.getLogger(__name__)

__all__ = ["decode_program_ids", "programs_to_chains", "InferencePipeline", "PipelineResult",
           "CHAIN_MODES", "per_question_rows"]

CHAIN_MODES = ("sorted", "bucketed", "pool", "plain")


def decode_program_ids(
    program_ids: np.ndarray,
    idx_to_token: Mapping[int, str],
    mode: str = "postfix",
) -> List[Optional[List[Dict[str, Any]]]]:
    """Decoded generator ids -> program node lists (None where unparseable).

    Strips <START>/<END>/<NULL> (stopping at <END>) and inverts the ``mode``
    linearization with the arity parser; a malformed program gives None.
    """
    parse = {"postfix": prog.postfix_to_list, "prefix": prog.prefix_to_list}.get(mode)
    if parse is None:
        raise ValueError(f"unknown program mode {mode!r}")
    out: List[Optional[List[Dict[str, Any]]]] = []
    for row in np.asarray(program_ids):
        tokens: List[str] = []
        for idx in row:
            token = idx_to_token.get(int(idx), NULL)
            if token == END:
                break
            if token in (NULL, START):
                continue
            tokens.append(token)
        try:
            out.append(parse([prog.parse_function_token(t) for t in tokens]))
        except IndexError:  # the arity structure ran out of tokens
            out.append(None)
    return out


def programs_to_chains(
    programs: Sequence[Optional[Sequence[Dict[str, Any]]]],
    image_index: np.ndarray,
    function_vocab: Mapping[str, int],
    max_steps: int = 28,
) -> ChainArrays:
    """Node lists -> ChainArrays.  Unparseable programs become 1-step no-ops
    (their answers read as token 0); programs deeper than ``max_steps`` are cut
    and counted in ``truncated``."""
    n = len(programs)
    functions = np.zeros((n, max_steps), np.int32)
    deps = np.full((n, max_steps, 2), -1, np.int64)
    num_steps = np.ones(n, np.int32)
    truncated = 0
    for i, program in enumerate(programs):
        if not program:
            continue
        truncated += int(len(program) > max_steps)
        program = list(program)[:max_steps]
        num_steps[i] = len(program)
        for s, node in enumerate(program):
            functions[i, s] = function_vocab.get(prog.function_token(node), 0)
            for d, dep in enumerate(node.get("inputs", [])[:2]):
                deps[i, s, d] = dep
    if truncated:
        logger.warning(
            "programs_to_chains: %d generated programs exceed max_steps=%d and were "
            "truncated (their answers will read a mid-chain value)", truncated, max_steps)
    return ChainArrays(np.asarray(image_index, np.int32), functions, deps, num_steps, [],
                       truncated=truncated)


def per_question_rows(image_tokens, image_index: np.ndarray):
    """Rows ``image_index`` of the per-IMAGE feature cache: gathered on the
    tensor's device, or on the host for numpy."""
    if isinstance(image_tokens, torch.Tensor):
        index = torch.as_tensor(image_index, dtype=torch.long, device=image_tokens.device)
        return image_tokens[index]
    return np.asarray(image_tokens)[image_index]


@dataclass
class PipelineResult:
    program_ids: np.ndarray  # (N, T) generated program tokens
    answers: np.ndarray  # (N,) predicted answer token ids (value vocab)
    answer_valid: np.ndarray  # (N,) final step produced a token
    tally: Optional[FaithfulnessTally] = None
    truncated: int = 0  # generated programs cut at the runner's max_steps


class InferencePipeline:
    """Generator + executor end-to-end runner."""

    def __init__(
        self,
        generator,
        runner: ExecutorChainRunner,
        program_idx_to_token: Mapping[int, str],
        executor_function_vocab: Mapping[str, int],
        mode: str = "postfix",
        device: Device = "cuda",
    ):
        self.device = resolve_device(device)
        self.generator = generator.eval()
        self.runner = runner
        self.program_idx_to_token = dict(program_idx_to_token)
        self.executor_function_vocab = dict(executor_function_vocab)
        self.mode = mode

    def run(
        self,
        questions: np.ndarray,
        image_tokens,
        image_index: np.ndarray,
        gt_answers: Optional[np.ndarray] = None,
        gt_programs: Optional[np.ndarray] = None,
        chain_mode: str = "sorted",
    ) -> PipelineResult:
        """``image_tokens`` is the per-IMAGE feature cache (M, P, C), numpy or a
        tensor; ``image_index`` maps each question to its image.  The pool
        indexes the cache itself; the other modes take one row per question,
        gathered on the tensor's device or on the host for numpy."""
        if chain_mode not in CHAIN_MODES:
            raise ValueError(f"unknown chain_mode {chain_mode!r}; one of {CHAIN_MODES}")
        q = torch.as_tensor(np.asarray(questions), device=self.device)
        program_ids = self.generator.generate(q).cpu().numpy()
        programs = decode_program_ids(program_ids, self.program_idx_to_token, self.mode)
        chains = programs_to_chains(
            programs, image_index, self.executor_function_vocab, self.runner.max_steps)
        if chain_mode == "pool":
            out = self.runner.run_pool(image_tokens, chains)
        else:
            run = {"sorted": self.runner.run_sorted, "bucketed": self.runner.run_bucketed,
                   "plain": self.runner.run}[chain_mode]
            out = run(per_question_rows(image_tokens, chains.image_index), chains)
        result = PipelineResult(
            program_ids=program_ids,
            answers=out["final_tokens"],
            answer_valid=out["final_is_token"],
            truncated=chains.truncated,
        )
        if gt_answers is not None and gt_programs is not None:
            answers = np.where(result.answer_valid, result.answers, -1)
            result.tally = tally_faithfulness(
                answers, np.asarray(gt_answers), program_ids, np.asarray(gt_programs))
        return result
