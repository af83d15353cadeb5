"""Result plotting and PDE-solution animation (matplotlib).

Counterpart of ``mioc_tpu.utils.plotting`` (the reference's
``plot_results``, ``HelpFunctions.jl:280-393``, and
``plot_solution``/``animate_solution``, ``julia_fem/plot_solution.jl``):
step plots of integer controls with the normalized gradient overlay, ODE
state trajectories, PDE surface snapshots, and MP4/GIF animation of
time-dependent PDE states with synchronized control subplots.  Every
control/gradient component is also exported in pgfplots ``.dat`` format
(``HelpFunctions.jl:384-392``), the same bytes as the JAX package's for the
same values.  Tensors are read back from their device once, as numpy.

Matplotlib is imported lazily with the Agg backend so headless use works.
"""

from __future__ import annotations

import numpy as np
import torch

from .io import save_latex_format

__all__ = ["plot_results", "plot_solution", "animate_solution"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(a):
    """``a`` as a numpy array, read back from its device if a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_results(obj, filename="results.png", data_dir="data_files", show=False):
    """Plot control components, normalized ∇f, and states; save ``.dat``
    exports (HelpFunctions.jl:280-393)."""
    plt = _mpl()
    x = _host(obj.x)                 # (nt, nx)
    df = _host(obj.df) if obj.df is not None else np.zeros_like(x)
    N, M = obj.nu, obj.nv
    t = np.linspace(obj.T0, obj.T1, obj.nt)

    max_df = np.abs(df).max() or 1.0
    df_n = df / max_df

    from ..objectives.ode import ODEObjective

    is_ode = isinstance(obj, ODEObjective)
    # Mixed problems use the reference's two-column grid: continuous controls
    # in column 1, integer controls in column 2 (HelpFunctions.jl:290-296).
    ncols = 2 if (N > 0 and M > 0) else 1
    rows = max(N, M, 1) + (1 if is_ode else 0)
    fig, axes = plt.subplots(rows, ncols, figsize=(8 * ncols, 2.2 * rows),
                             squeeze=False)

    for i in range(N):
        ax = axes[i, 0]
        ax.plot(t, x[:, i], "g-", lw=2, label=f"u{i+1}")
        ax.plot(t, df_n[:, i], "r-", lw=1, label=f"∇f_u{i+1}")
        ax.legend(loc="upper right")
        save_latex_format(t, x[:, i], f"u({i+1})", data_dir)
        save_latex_format(t, df_n[:, i], f"nabla_f_u({i+1})", data_dir)
    for i in range(M):
        ax = axes[i, ncols - 1]
        ax.step(t, x[:, N + i], "g-", lw=2, where="post", label=f"v{i+1}")
        ax.plot(t, df_n[:, N + i], "r-", lw=1, label=f"∇f_v{i+1}")
        ax.legend(loc="upper right")
        save_latex_format(t, x[:, N + i], f"v({i+1})", data_dir)
        save_latex_format(t, df_n[:, N + i], f"nabla_f_v({i+1})", data_dir)

    if is_ode and obj.state is not None:
        state = np.concatenate([_host(obj.state0)[None], _host(obj.state)[:-1]])
        ax = axes[-1, 0]
        for j in range(state.shape[1]):
            ax.plot(t, state[:, j], lw=2, label=f"y{j+1}")
            save_latex_format(t, state[:, j], f"y({j+1})", data_dir)
        ax.set_title("States")
        ax.legend(loc="upper right")

    fig.tight_layout()
    fig.savefig(filename, dpi=110)
    if show:
        plt.show()
    plt.close(fig)
    return filename


def plot_solution(mesh, U, title="", filename="solution.png"):
    """3D surface plot of a P1 coefficient vector on the mesh
    (plot_solution.jl:12-51)."""
    plt = _mpl()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    p = np.asarray(mesh.p)
    U = _host(U)[: mesh.np]
    ax.plot_trisurf(p[:, 0], p[:, 1], U, triangles=np.asarray(mesh.t),
                    cmap="viridis", linewidth=0.1)
    ax.set_title(title)
    fig.savefig(filename, dpi=110)
    plt.close(fig)
    return filename


def animate_solution(mesh, state, tau, filename="final-state", *, u=None, v=None,
                     u_range=None, v_range=None, fps=20, max_frames=200):
    """Animate a time-dependent PDE state (columns of ``state``) with
    synchronized control subplot (plot_solution.jl:61-233).  Writes an
    ``.mp4`` when ffmpeg is available, else an animated ``.gif`` (the JAX
    package's writer rule)."""
    plt = _mpl()
    from matplotlib import animation, tri as mtri

    state = _host(state)
    if state.shape[0] != mesh.np and state.shape[1] >= mesh.np:
        state = state.T  # accept (nt+1, N) time-major storage
    nt1 = state.shape[1]
    stride = max(1, nt1 // max_frames)
    frames = range(0, nt1, stride)

    p = np.asarray(mesh.p)
    triang = mtri.Triangulation(p[:, 0], p[:, 1], np.asarray(mesh.t))
    vmin, vmax = state[: mesh.np].min(), state[: mesh.np].max()

    has_ctrl = v is not None and np.size(v) > 0
    fig, axes = plt.subplots(
        1, 2 if has_ctrl else 1, figsize=(11 if has_ctrl else 6, 5),
        squeeze=False,
    )
    ax = axes[0, 0]

    def draw(i):
        ax.clear()
        ax.tripcolor(triang, state[: mesh.np, i], vmin=vmin, vmax=vmax,
                     shading="gouraud", cmap="inferno")
        ax.set_title(f"t = {i * tau:.2f}")
        if has_ctrl:
            ax2 = axes[0, 1]
            ax2.clear()
            vv = _host(v)
            tgrid = np.arange(vv.shape[0]) * tau
            for j in range(vv.shape[1]):
                ax2.step(tgrid, vv[:, j], where="post", label=f"v{j+1}")
            ax2.axvline(i * tau, color="k", lw=1)
            if v_range is not None:
                ax2.set_ylim(v_range)
            ax2.legend(loc="upper right")
        return []

    anim = animation.FuncAnimation(fig, draw, frames=frames, blit=False)
    try:
        out = filename + ".mp4"
        anim.save(out, writer=animation.FFMpegWriter(fps=fps))
    except Exception:  # no ffmpeg (or it failed): the JAX package's GIF rule
        out = filename + ".gif"
        anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out
