"""Faults planted under the timed path, for the calibration of the limits
and for the tests that see ``correct`` come out false, and the control:
the plain reference computed in the precision below the one the
configuration states (bf16 -> fp8: every product's operands and every
stored activation in float8 e4m3 with a per-tensor scale, forward and
backward), put in the program's place."""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.model import Precision


def unchanged_state(step):
    """A step that returns its state unchanged (its metrics as usual)."""
    def broken(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return broken


def take_rows(batch: dict, n: int) -> dict:
    out = {k: v[:n] for k, v in batch.items() if k != "sup"}
    sup = batch["sup"]
    out["sup"] = dataclasses.replace(sup, **{
        f.name: getattr(sup, f.name)[:n] for f in dataclasses.fields(sup)
        if hasattr(getattr(sup, f.name), "shape")})
    return out


def half_batch(step):
    """A step that leaves out half of the batch and takes its mean over
    the rest."""
    def broken(state, batch):
        return step(state, take_rows(batch, batch["feats"].shape[0] // 2))
    return broken


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}


def fp8_round(x):
    """x rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude to 448), back in float32."""
    s = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


def bf16_round(x):
    return x.to(torch.bfloat16).float()


def rounded(rnd) -> Precision:
    """Products whose operands, and stores whose values, are rounded by
    ``rnd``, in the forward pass and in the backward's products with the
    incoming gradient."""

    class MM(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            qa, qb = rnd(a), rnd(b)
            ctx.save_for_backward(qa, qb)
            return torch.matmul(qa, qb)

        @staticmethod
        def backward(ctx, g):
            qa, qb = ctx.saved_tensors
            qg = rnd(g)
            return (torch.matmul(qg, qb.T),
                    qa.reshape(-1, qa.shape[-1]).T
                    @ qg.reshape(-1, qg.shape[-1]))

    class Cast(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return rnd(x)

        @staticmethod
        def backward(ctx, g):
            return rnd(g)

    return Precision(mm=MM.apply, cast=Cast.apply)


# the control; and the plain reference in the configuration's own bf16,
# the witness that the program's readings are what bf16 gives
FP8 = rounded(fp8_round)
BF16 = rounded(bf16_round)
