"""The comparison that decides `correct` for a served model.

The reference is run once over each sampled prompt with the tokens the
program served (model.served_logits). At every served position, the gap
is how far the served token's reference logit lies below the
reference's best allowed token (the cell's banned ids excluded on both
sides). The run's numbers are the widest gap over the sample and the
error variance the flips imply (`served_numbers`); the cell's file says
which of them it holds to a limit, and the others are printed beside.
A control (a lower precision in the program's place) is read the same
way, with the token the control puts first at each position in place of
the served one.
"""

from __future__ import annotations

import torch

# the least share of positions under a 0.01 margin that `err2` divides
# by: 62 positions of a 6,208-token sample, ~13% counting noise
MIN_TIE_SHARE = 0.01


def allowed_mask(vocab: int, banned_ids: list, banned_from: int | None,
                 device) -> torch.Tensor:
    """(vocab,) bool: False at the banned ids and from `banned_from` on."""
    ok = torch.ones(vocab, dtype=torch.bool, device=device)
    if banned_ids:
        ok[torch.tensor(banned_ids, device=device)] = False
    if banned_from is not None:
        ok[banned_from:] = False
    return ok


def gaps(ref: torch.Tensor, picked: torch.Tensor, ok: torch.Tensor
         ) -> torch.Tensor:
    """(T,) gaps of `picked` (T,) under reference logits `ref` (T, V); a
    banned pick has an infinite gap."""
    masked = ref.masked_fill(~ok, float("-inf"))
    best = masked.max(dim=-1).values
    return best - masked.gather(-1, picked[:, None])[:, 0]


def margins(refs: list, ok: torch.Tensor) -> torch.Tensor:
    """The reference's margin between its best and second allowed token
    at every position: where it is small, a rounding can flip the pick."""
    top = torch.cat([r.masked_fill(~ok, float("-inf")).topk(2, dim=-1)
                     .values for r in refs])
    return top[:, 0] - top[:, 1]


def summarize(all_gaps: list) -> dict:
    """The run's numbers from each request's gaps (an empty sample reads
    as an infinite gap: nothing was served to compare)."""
    if not all_gaps:
        return {"gap_max": float("inf"), "gap_mean": float("inf"),
                "not_best_share": 1.0, "tokens": 0}
    g = torch.cat([x.float().flatten() for x in all_gaps])
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "not_best_share": float((g > 0).float().mean()),
            "tokens": int(g.numel())}


def served_numbers(refs: list, served: list, ok: torch.Tensor) -> dict:
    """The program's numbers: each served token against the reference;
    the share of positions whose reference margin is under 0.01 (where a
    flip can happen at all); and `err2`, the served logits' error
    variance that the flips imply.

    A pick flips where the reference's margin m between its best two is
    below the program's error δ on their difference, and then its gap is
    m. With ρ positions per unit of margin near 0, the mean gap is
    ρ E[δ²] / 2 and the share of margins under 0.01 is 0.01 ρ, so
    err2 = 0.02 x mean gap / that share estimates E[δ²] whatever the
    seed's model makes of its margins; the widest gap and the mean gap
    themselves grow with how many near-ties a seed's model has.

    The share is taken as at least `MIN_TIE_SHARE`: on a draw whose
    margins are sparse near 0 (a few positions in a sample), ρ is read
    from a handful of counts and one or two flips from wider margins
    would read as a large error; floored, such a draw can only read
    lower."""
    out = summarize([gaps(r, torch.as_tensor(s, device=r.device), ok)
                     for r, s in zip(refs, served)])
    ties = (float((margins(refs, ok) < 0.01).float().mean()) if refs
            else 0.0)
    out["margin_under_0.01"] = ties
    out["err2"] = 0.02 * out["gap_mean"] / max(ties, MIN_TIE_SHARE)
    return out


def control_numbers(refs: list, controls: list, ok: torch.Tensor) -> dict:
    """A control's numbers: the token it puts first at each position."""
    return summarize([
        gaps(r, c.masked_fill(~ok, float("-inf")).argmax(-1), ok)
        for r, c in zip(refs, controls)])
