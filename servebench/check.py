"""How ``correct`` is decided, once the window has closed.

A sample of the requests the window finished, drawn from the seed, with
the longest of them (prompt and output) in it, and one whose prefill
rode on a decode batch where there was one, up to ``sample_tokens``
served tokens in 3 requests or more (or ``sample_requests``). For each,
the reference runs once over the prompt and the tokens the port served
(the prompt's token ids worked out again as the port draws them:
``np.random.default_rng(rid)`` over the vocabulary), in f32. A served
token's gap is the reference's best logit at its position minus the
reference's logit of the served token; ``widest_gap``, the largest over
the sample, is compared with the cell's limit. The port samples
greedily, so a sound run's gaps are rounding: a bf16 model's argmax may
differ where the reference's two best logits lie close. In a MoE layer
rounding can also flip a route where the router's k-th and (k+1)-th
logits lie within it, and a flipped route moves a token's logits by far
more than rounding does: the gap is then taken over the positions whose
every routing margin in the reference is at least the cell's
``route_margin``, and the share left out is held to ``left_out_share``.
A finished request must also have been served exactly its output length
(``tokens_missing``).

The reference is the configuration's architecture's
(``servebench/reference/<arch>.py``). The control (``control=True``, run
by ``servebench/calibrate.py``, not by the benchmark's runs): the same
reference computed in e4m3, whose argmax at each position is judged by
the f32 reference's gap in the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Item:
    rid: int
    prompt: int          # prompt tokens
    output: int          # output tokens asked for
    served: tuple        # the tokens the port served


def prompt_ids(rid: int, prompt: int, vocab: int) -> np.ndarray:
    """The prompt the port's executor draws for request ``rid``."""
    return np.random.default_rng(rid).integers(
        0, vocab, size=prompt).astype(np.int64)


LEAST = 3            # requests a sample holds at least, where there are


def pick(finished: list, ridden: set, seed: int, tokens: int,
         most: int) -> list:
    """Indices into ``finished`` (``(rid, prompt, output)`` triples): the
    longest, one that rode on a decode batch, then a seeded draw of the
    rest, until ``tokens`` output tokens in ``LEAST`` requests or more, or
    ``most`` requests."""
    if not finished:
        return []
    order = [max(range(len(finished)),
                 key=lambda i: (finished[i][1] + finished[i][2], -i))]
    rode = [i for i, f in enumerate(finished)
            if f[0] in ridden and i not in order]
    rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
    if rode:
        order.append(rode[int(rng.integers(len(rode)))])
    rest = [i for i in rng.permutation(len(finished)) if i not in order]
    chosen, total = [], 0
    for i in order + rest:
        if len(chosen) >= most or (total >= tokens
                                   and len(chosen) >= LEAST):
            break
        chosen.append(int(i))
        total += finished[i][2]
    return chosen


def sample(win, port, cell, seed: int) -> list:
    """The ``Item``s a window's check compares: ``pick`` over the requests
    it finished (one never restarted, so its prompt is the one drawn),
    with the tokens the port served them."""
    finished = [(r.rid, r.prompt_len, r.output_len) for r in win.requests
                if r.finish_time is not None and r.prior_tokens == 0]
    chosen = pick(finished, win.recorder.ridden, seed,
                  cell.correct["sample_tokens"],
                  cell.correct["sample_requests"])
    return [Item(rid, p, o, tuple(port.tokens(rid)))
            for rid, p, o in (finished[i] for i in chosen)]


MARGINS = (0.0, 0.005, 0.01, 0.02, 0.03, 0.05)   # margins calibrate shows


def gaps(weights: dict, config, items: list, device,
         route_margin: float = 0.0, control: bool = False) -> dict:
    """``widest_gap``: the widest gap of the served tokens over ``items``,
    by the reference of ``config``'s architecture, at the positions whose
    routes the reference does not find near a tie: where every MoE layer's
    routing margin (its k-th router logit less its (k+1)-th) is at least
    ``route_margin`` (every position, where the reference returns no
    margins); ``left_out``, the positions that are not. With ``control``,
    also the e4m3 reference's (``control_widest_gap``), and where there
    are margins, both at each of ``MARGINS``."""
    import torch
    ref = config.reference
    sizes = ref.arch(config.raw)
    vocab = config.arch.vocab(config.raw)
    seqs, firsts = [], []
    for it in items:
        p = prompt_ids(it.rid, it.prompt, vocab)
        toks = np.concatenate([p, np.asarray(it.served[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        firsts.append(it.prompt - 1)
    out = {"tokens_compared": sum(len(it.served) for it in items)}
    with torch.no_grad():
        margins: list = []
        exact = ref.logits(weights, sizes, seqs, firsts, "f32",
                           margins=margins)
        best = [x.max(dim=-1).values for x in exact]
        runs = [("", [torch.as_tensor(list(it.served), device=device)
                      for it in items])]
        if control:
            low = ref.logits(weights, sizes, seqs, firsts, "e4m3")
            runs.append(("control_", [x.argmax(dim=-1) for x in low]))
        margin = torch.cat(margins) if margins else None
        keep = None if margin is None else margin >= route_margin
        out["left_out"] = 0 if keep is None else int((~keep).sum())
        for prefix, tokens in runs:
            g = torch.cat([b - x.gather(1, t[:, None])[:, 0]
                           for x, b, t in zip(exact, best, tokens)])
            kept = g if keep is None else g[keep]
            out[prefix + "widest_gap"] = float(kept.max()) \
                if kept.numel() else -1.0
            if control and margin is not None:
                for m in MARGINS:
                    k = margin >= m
                    out[f"{prefix}widest_gap_margin_{m}"] = \
                        float(g[k].max()) if k.any() else -1.0
                    out[f"left_out_margin_{m}"] = int((~k).sum())
    return out
