"""The event loop's per-pixel state and its advance after a round.

Shared by the round loop (``kernel._detect_batch``) and the plain version
of the whole-loop kernel (``cuda_ops.detect_mega_plain``).  The state is a
dict of ``phase``, ``cur_i``, ``cur_k``, ``n_last_fit`` [C,P] int32,
``first_seg`` [C,P] bool, ``alive`` and ``included`` [C,T,P] bool,
``coefs`` [C,P,B,8] and ``rmse`` [C,P,B] float32, ``nseg`` [C,P] int32 and
the segment buffers ``bufs``.
"""

from __future__ import annotations

import torch

# The phase codes (kernel._detect_batch_impl's; csrc/ccd_common.cuh holds
# the same values for detect_mega).
PHASE_INIT, PHASE_MONITOR, PHASE_DONE = 0, 1, 2


def init_zeros(st):
    """The INIT block's outputs on a round where no pixel initializes
    (every consumer masks on in_init-derived flags)."""
    zb = torch.zeros_like(st["cur_i"], dtype=torch.bool)
    zi = torch.zeros_like(st["cur_i"])
    return dict(init_nowin=zb, init_tm=zb, init_ok=zb, init_bad=zb,
                has_adv=zb, i_next_tm=zi, i_adv=zi, j=zi,
                w_stab=torch.zeros_like(st["alive"]), n_ok=zi,
                alive_init=st["alive"])


def next_state(st, init, ev, coefs, rmse, nseg, bufs):
    """The event loop's state after a round — kernel._detect_batch_impl's
    loop body.  ``st`` is the round-start state, ``init`` the INIT block's
    outputs, ``ev`` the round's events (is_tail, is_brk, is_refit, pos_ev,
    do_fit, n_full [C,P]; included_mon, alive_mon [C,T,P]); ``coefs``,
    ``rmse``, ``nseg`` and ``bufs`` the model and segments after the
    round's close and refit."""
    phase = st["phase"]
    in_init = phase == PHASE_INIT
    in_mon = phase == PHASE_MONITOR
    init_ok = init["init_ok"]
    is_tail, is_brk, is_refit = ev["is_tail"], ev["is_brk"], ev["is_refit"]
    done = init["init_nowin"] | (init["init_bad"] & ~init["has_adv"])
    phase_n = torch.where(
        done, PHASE_DONE,
        torch.where(init_ok, PHASE_MONITOR,
                    torch.where(is_tail, PHASE_DONE,
                                torch.where(is_brk, PHASE_INIT, phase))))
    cur_i_n = torch.where(
        init["init_tm"], init["i_next_tm"],
        torch.where(init["init_bad"] & init["has_adv"], init["i_adv"],
                    torch.where(is_brk, ev["pos_ev"], st["cur_i"])))
    cur_k_n = torch.where(init_ok, init["j"] + 1,
                          torch.where(is_refit, ev["pos_ev"] + 1,
                                      st["cur_k"]))
    alive_n = torch.where(in_init[:, None, :], init["alive_init"],
                          torch.where(in_mon[:, None, :], ev["alive_mon"],
                                      st["alive"]))
    included_n = torch.where(
        init_ok[:, None, :], init["w_stab"],
        torch.where(is_brk[:, None, :], False,
                    torch.where(in_mon[:, None, :], ev["included_mon"],
                                st["included"])))
    nlast_n = torch.where(ev["do_fit"], ev["n_full"], st["n_last_fit"])
    i32 = torch.int32
    return dict(phase=phase_n.to(i32), cur_i=cur_i_n.to(i32),
                cur_k=cur_k_n.to(i32), alive=alive_n, included=included_n,
                coefs=coefs, rmse=rmse, n_last_fit=nlast_n.to(i32),
                first_seg=st["first_seg"] & ~is_brk, nseg=nseg, bufs=bufs)
