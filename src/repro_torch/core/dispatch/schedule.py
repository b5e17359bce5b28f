"""Schedule stage: the execution skeleton over routing + transport +
compute (the counterpart of ``repro/core/dispatch/schedule.py``).

The sync ``a2a`` path is :func:`software_pipeline` at ``num_chunks == 1``:
one dispatch, one compute, one combine.  The chunked ``a2a_pipelined``
schedule reuses it with more chunks once the communication model is
ported.
"""

from __future__ import annotations


def software_pipeline(num_chunks: int, dispatch, compute, combine, carry):
    """Unrolled 3-stage software pipeline over ``num_chunks`` chunks.

    At tick ``t`` it issues the dispatch of chunk ``t``, the compute of
    chunk ``t - 1`` and the combine of chunk ``t - 2``.  ``dispatch(j)``
    produces chunk ``j``'s in-flight value, ``compute(j, v)`` transforms it
    and ``combine(carry, j, v)`` folds it into ``carry``.  With
    ``num_chunks == 1``: dispatch(0); compute(0); combine(0).
    """
    in_dispatch = None            # (j, dispatched chunk j)
    in_compute = None             # (j, computed chunk j)
    for t in range(num_chunks + 2):
        nxt = (t, dispatch(t)) if t < num_chunks else None
        cmp = (in_dispatch[0], compute(*in_dispatch)) \
            if in_dispatch is not None else None
        if in_compute is not None:
            carry = combine(carry, *in_compute)
        in_dispatch, in_compute = nxt, cmp
    return carry
