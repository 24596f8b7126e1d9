"""The fixed contraction set of the MPS classifier, as einsums and loops.

Each contraction pattern of the algorithm is a fixed ``torch.einsum``; the
sequential site chain is a Python loop over sites. Patterns with three or
more operands are written as a chain of two-operand einsums in a fixed
order, so that no step builds an ``(M, M, B)`` intermediate whatever
contraction order ``torch.einsum`` would pick on its own.

Index naming convention used throughout (einsum subscripts):
    ``n`` site index,  ``b`` batch,  ``l``/``r`` left/right bond (dim M),
    ``d`` physical/feature leg (dim D),  ``o`` output label leg (dim L).

Shapes:
    sites       (N, M, D, M)   padded uniform site stack
    label_site  (M, D, L, M)   the site carrying the label leg
    phi         (B, N, D)      embedded input
    mats        (N, B, M, M)   per-site input-contracted transfer matrices
    envs        (B, M)         left/right environment vectors
"""

from __future__ import annotations

import torch


def boundary_vector(M: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """One-hot boundary vector ``e0`` closing the padded open chain."""
    e0 = torch.zeros((M,), dtype=dtype, device=device)
    e0[0] = 1.0
    return e0


def site_mats(sites: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Contract every site with its input feature: ``(N,B,M,M)`` transfer mats."""
    return torch.einsum("nldr,bnd->nblr", sites, phi)


def _left_step(v: torch.Tensor, p: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``v'[b,r] = sum_{l,d} v[b,l] p[b,d] A[l,d,r]``."""
    w = torch.einsum("bl,bd->bld", v, p)
    return torch.einsum("bld,ldr->br", w, A)


def _right_step(A: torch.Tensor, p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v'[b,l] = sum_{d,r} A[l,d,r] p[b,d] v[b,r]``."""
    w = torch.einsum("bd,br->bdr", p, v)
    return torch.einsum("ldr,bdr->bl", A, w)


def left_env_stack(mats: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """All left (prefix) environments: out[n] = e0 . mats[0] ... mats[n-1].

    Returns ``(N+1, B, M)``; ``out[0]`` is the broadcast boundary vector.
    """
    N, B, M, _ = mats.shape
    v = e0.expand(B, M)
    out = [v]
    for n in range(N):
        v = torch.einsum("bl,blr->br", v, mats[n])
        out.append(v)
    return torch.stack(out)


def right_env_stack(mats: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """All right (suffix) environments: out[n] = mats[n] ... mats[N-1] . e0.

    Returns ``(N+1, B, M)``; ``out[N]`` is the broadcast boundary vector.
    """
    N, B, M, _ = mats.shape
    v = e0.expand(B, M)
    out = [v]
    for n in reversed(range(N)):
        v = torch.einsum("blr,br->bl", mats[n], v)
        out.append(v)
    return torch.stack(out[::-1])


def left_env_stack_parallel(mats: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """``left_env_stack`` with O(log N) sequential depth: the prefix products
    ``mats[0] @ ... @ mats[n]`` as a tree of batched ``torch.matmul`` (an
    inclusive scan: ``ceil(log2 N)`` rounds, each one product over the whole
    stack), then closed on ``e0``. O(N log N) M^3 products against the
    loop's O(N) M^2 ones: the JAX package's ``associative_scan`` form, worth
    it where the chain is split across devices or N dominates."""
    N, B, M, _ = mats.shape
    prods, shift = mats, 1
    while shift < N:  # prods[i] <- prods[i - shift] @ prods[i]
        prods = torch.cat([prods[:shift], prods[:-shift] @ prods[shift:]])
        shift *= 2
    envs = torch.einsum("l,nblr->nbr", e0, prods)
    return torch.cat([e0.expand(1, B, M), envs])


def right_env_stack_parallel(mats: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """``right_env_stack`` with O(log N) sequential depth: the suffix
    products ``mats[n] @ ... @ mats[N-1]`` by the same tree, right to left."""
    N, B, M, _ = mats.shape
    prods, shift = mats, 1
    while shift < N:  # prods[i] <- prods[i] @ prods[i + shift]
        prods = torch.cat([prods[:-shift] @ prods[shift:], prods[-shift:]])
        shift *= 2
    envs = torch.einsum("nblr,r->nbl", prods, e0)
    return torch.cat([envs, e0.expand(1, B, M)])


def left_env_stack_fused(
    sites: torch.Tensor, phi_t: torch.Tensor, e0: torch.Tensor
) -> torch.Tensor:
    """Prefix environments with the site-input contraction fused in.

    ``sites (n, M, D, M)``, ``phi_t (n, B, D)`` (site-major). Equal to
    ``left_env_stack(site_mats(sites, phi), e0)`` without the
    ``(N, B, M, M)`` transfer-matrix stack.
    """
    B, M = phi_t.shape[1], sites.shape[1]
    v = e0.expand(B, M)
    out = [v]
    for A, p in zip(sites, phi_t):
        v = _left_step(v, p, A)
        out.append(v)
    return torch.stack(out)


def right_env_stack_fused(
    sites: torch.Tensor, phi_t: torch.Tensor, e0: torch.Tensor
) -> torch.Tensor:
    """Suffix environments with the site-input contraction fused in.

    Equal to ``right_env_stack(site_mats(sites, phi), e0)``.
    """
    B, M = phi_t.shape[1], sites.shape[1]
    v = e0.expand(B, M)
    out = [v]
    for n in reversed(range(sites.shape[0])):
        v = _right_step(sites[n], phi_t[n], v)
        out.append(v)
    return torch.stack(out[::-1])


def left_env_final_fused(
    sites: torch.Tensor, phi_t: torch.Tensor, e0: torch.Tensor
) -> torch.Tensor:
    """Final left environment ``(B, M)``, embedding fused, no stacks."""
    B, M = phi_t.shape[1], sites.shape[1]
    v = e0.expand(B, M)
    for A, p in zip(sites, phi_t):
        v = _left_step(v, p, A)
    return v


def right_env_final_fused(
    sites: torch.Tensor, phi_t: torch.Tensor, e0: torch.Tensor
) -> torch.Tensor:
    """Final right environment ``(B, M)``, embedding fused, no stacks."""
    B, M = phi_t.shape[1], sites.shape[1]
    v = e0.expand(B, M)
    for n in reversed(range(sites.shape[0])):
        v = _right_step(sites[n], phi_t[n], v)
    return v


def left_env_final(mats: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """Just the final left environment ``(B, M)`` (no stacked prefixes)."""
    N, B, M, _ = mats.shape
    v = e0.expand(B, M)
    for n in range(N):
        v = torch.einsum("bl,blr->br", v, mats[n])
    return v


def right_env_final(mats: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """Just the final right environment ``(B, M)``."""
    N, B, M, _ = mats.shape
    v = e0.expand(B, M)
    for n in reversed(range(N)):
        v = torch.einsum("blr,br->bl", mats[n], v)
    return v


def chain_scores(
    left_env: torch.Tensor,
    label_site: torch.Tensor,
    x_label: torch.Tensor,
    right_env: torch.Tensor,
) -> torch.Tensor:
    """Unactivated class scores ``(L, B)``.

    Closes the chain: left env x label-site x its input feature x right env,
    label axis first.
    """
    w = torch.einsum("bl,bd->bld", left_env, x_label)
    y = torch.einsum("bld,ldor->bor", w, label_site)
    return torch.einsum("bor,br->ob", y, right_env)


def transfer_suffix_stack(sites: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """Suffix products of L2 transfer matrices, ``(N+1, M, M)``.

    ``out[n] = T_n T_{n+1} ... T_{N-1} . (e0 e0^T)`` where
    ``T_n[l l', r r'] = sum_d A_n[l,d,r] A_n[l',d,r']``: the transfer-matrix
    contraction of a site with itself used by the exact L2 norm of the MPS.
    """
    E = torch.outer(e0, e0)
    out = [E]
    for n in reversed(range(sites.shape[0])):
        A = sites[n]
        E = torch.einsum("lds,mds->lm", torch.einsum("ldr,rs->lds", A, E), A)
        out.append(E)
    return torch.stack(out[::-1])


def transfer_append(E: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Extend a left L2 transfer product by one site: ``E' = A^T E A`` over d.

    ``E'[r,r'] = sum_{l l' d} A[l,d,r] E[l,l'] A[l',d,r']``.
    """
    return torch.einsum("mdr,mds->rs", torch.einsum("ldr,lm->mdr", A, E), A)


def env_apply_site(
    left_env: torch.Tensor, x: torch.Tensor, site: torch.Tensor
) -> torch.Tensor:
    """Extend a left environment by one (input-contracted) site.

    ``v'[b,r] = sum_{l,d} v[b,l] x[b,d] A[l,d,r]``.
    """
    return _left_step(left_env, x, site)
