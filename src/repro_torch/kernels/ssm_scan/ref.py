"""The plain selective scan (mamba-1 SSM), the plain version of B13, as
``repro.kernels.ssm_scan.ref`` writes it.

Recurrence (diagonal A), per batch row and channel d:

    abar_t = exp(dt_t * A)              A = -exp(A_log) < 0
    h_t    = abar_t * h_{t-1} + dt_t * B_t * x_t
    y_t    = <h_t, C_t>                 (the D*x skip stays outside)

Shapes: dt, x [B, S, D]; Bmat, Cmat [B, S, N]; A [D, N]; h0 [B, D, N].
Returns (y [B, S, D] in x's dtype, h_last [B, D, N] f32), the state in f32
throughout.  (``repro``'s ``ref.selective_scan`` returns y in f32 whatever
x is; its Pallas kernel, which this mirrors, returns y in x's dtype.)
"""
import torch


def selective_scan(dt, x, bmat, cmat, a, h0):
    s = x.shape[1]
    f32 = torch.float32
    h = h0.to(f32)
    dt, xf = dt.to(f32), x.to(f32)
    bmat, cmat = bmat.to(f32), cmat.to(f32)
    ys = []
    for t in range(s):
        abar = torch.exp(dt[:, t, :, None] * a)            # [B, D, N]
        bx = dt[:, t, :, None] * bmat[:, t, None, :] * xf[:, t, :, None]
        h = abar * h + bx
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(xf.shape)
    return y.to(x.dtype), h


def selective_scan_bwd(dt, x, bmat, cmat, a, h0, gy, gh=None, needs=None):
    """The vjp of :func:`selective_scan`: the reverse recurrence, step by
    step in f32, as ``repro``'s ``ops._bwd`` computes it (``jax.vjp`` of
    its reference loop).

    With ``abar_t = exp(dt_t A)`` and ``h_t`` the forward's states, the
    adjoint state ``lam`` (dL/dh_t) runs from ``gh`` at t = S-1 down to 0:

        lam   += gy_t * C_t
        dC_t   = sum_d h_t * gy_t           dB_t = sum_d lam * dt_t x_t
        dx_t   = dt_t * sum_n lam * B_t
        u      = lam * abar_t * h_{t-1}
        ddt_t  = sum_n A * u + x_t * sum_n lam * B_t
        dA    += dt_t * u                   (summed over b and t)
        lam    = abar_t * lam

    and ``dh0 = lam`` at the end.  ``gy`` [B,S,D] is y's cotangent, ``gh``
    [B,D,N] h_last's (None: zeros).  ``needs`` (six bools, in argument
    order; None: all) says which gradients to compute; the others are
    None.  Returns ``(ddt, dx, dB, dC, dA, dh0)`` in f32, dx in x's
    dtype.
    """
    needs = (True,) * 6 if needs is None else tuple(bool(w) for w in needs)
    s = x.shape[1]
    f32 = torch.float32
    dt, xf, gyf = dt.to(f32), x.to(f32), gy.to(f32)
    bmat, cmat = bmat.to(f32), cmat.to(f32)
    hs = [h0.to(f32)]                       # h_{t-1} for t = 0 .. S
    for t in range(s):
        abar = torch.exp(dt[:, t, :, None] * a)
        bx = dt[:, t, :, None] * bmat[:, t, None, :] * xf[:, t, :, None]
        hs.append(abar * hs[-1] + bx)
    lam = (hs[0].new_zeros(hs[0].shape) if gh is None
           else gh.to(f32).clone())
    ddt, dx, db, dc = (torch.zeros_like(dt) if needs[0] else None,
                       torch.zeros_like(xf) if needs[1] else None,
                       torch.zeros_like(bmat) if needs[2] else None,
                       torch.zeros_like(cmat) if needs[3] else None)
    da = torch.zeros_like(a, dtype=f32) if needs[4] else None
    for t in range(s - 1, -1, -1):
        dtt, xt, gyt = dt[:, t], xf[:, t], gyf[:, t]
        lam = lam + gyt[:, :, None] * cmat[:, t, None, :]
        if dc is not None:
            dc[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], gyt)
        if db is not None:
            db[:, t] = torch.einsum("bdn,bd->bn", lam, dtt * xt)
        abar = torch.exp(dtt[:, :, None] * a)
        sb = (lam * bmat[:, t, None, :]).sum(-1)             # [B, D]
        if dx is not None:
            dx[:, t] = dtt * sb
        if ddt is not None or da is not None:
            u = lam * abar * hs[t]
            if ddt is not None:
                ddt[:, t] = (u * a).sum(-1) + xt * sb
            if da is not None:
                da += (dtt[:, :, None] * u).sum(0)
        lam = abar * lam
    return (ddt, None if dx is None else dx.to(x.dtype), db, dc, da,
            lam if needs[5] else None)
