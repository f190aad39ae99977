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
