"""Challenge plane: stateless issuance, batched PoW verification on the
card (kernel C), bounded failure state.

  * issuer.py    — signed expiring challenge cookies in the reference's
                   exact wire format; a pure function of (secret, binding,
                   expiry), with no per-IP state.
  * verifier.py  — sha-inv PoW verification: wire checks on the host,
                   the leading-zero count batched onto the card
                   (matcher/kernels/pow_verify.py, csrc/pow_verify.cu).
  * failures.py  — per-IP failed-challenge state with the reference's
                   fixed-window semantics, bounded by an LRU exact tier
                   plus a sketch-gated spill table.
  * stats.py     — run counters.
"""
