"""Plain reference of the gradient film: per pixel the primal, and the
x / y gradients from the shifted (S) and MIS-weighted base (W) sums of
the four offsets right, left, down, up (computeGradient, gvpm.cpp:1205-1306
of the GVPM code release):

  Gx[x] = (S_right[x] - W_right[x]) + (W_left[x+1] - S_left[x+1])
  Gy[y] = (S_down[y] - W_down[y]) + (W_up[y+1] - S_up[y+1])
"""

from __future__ import annotations


def assemble(p, S, W, H, Wd):
    """p [n, 3], S and W [4, n, 3], n = H * Wd -> (primal, gx, gy)
    [H, Wd, 3]."""
    def img(a):
        return a.reshape(H, Wd, 3)

    gx = img(S[0]) - img(W[0])
    gx[:, :-1] += img(W[1])[:, 1:] - img(S[1])[:, 1:]
    gy = img(S[2]) - img(W[2])
    gy[:-1] += img(W[3])[1:] - img(S[3])[1:]
    return img(p), gx, gy
