"""Host-side top-down rendering (``Planar2DViewer``).

Counterpart of ``gymnasium_planar_robotics_tpu/utils/rendering.py``, the
reference's ``Matplotlib2DViewer`` view (tiles, movers with their collision
shapes, velocity arrows, goals, the pushed object) as a function of the
gathered state: interactive display or an offscreen rgb array.  Params and
state may hold tensors on any device (read through ``to_numpy``);
matplotlib is imported when a viewer is made.
"""

from __future__ import annotations

import numpy as np

from gymnasium_planar_robotics_tpu_torch.ops.kernels import to_numpy


class Planar2DViewer:
    """Top-down view of the tile table, movers, goals, and (optionally) the
    pushed object."""

    def __init__(self, params, interactive: bool = False, figure_size=(7, 7), mover_colors=None):
        import matplotlib

        if not interactive:
            matplotlib.use('Agg', force=False)
        import matplotlib.pyplot as plt

        self._plt = plt
        self._interactive = interactive
        self._params = params
        self._fig, self._ax = plt.subplots(figsize=figure_size)
        self._mover_colors = mover_colors
        if interactive:
            plt.ion()
            self._fig.show()

    def render(self, state: dict) -> np.ndarray | None:
        """Draw one frame.

        ``state`` keys: ``mover_xy [M, 2]``, ``mover_vel [M, 2]``,
        ``goals [M, 2]`` (optional), ``object_xy [2]``/``object_half [2]``
        (optional, pushing env).
        """
        import matplotlib.patches as patches

        p = self._params
        ax = self._ax
        ax.clear()

        layout = to_numpy(p.grid.layout)
        tx = to_numpy(p.grid.tile_x)
        ty = to_numpy(p.grid.tile_y)
        ts = to_numpy(p.grid.tile_size)
        for i in range(layout.shape[0]):
            for j in range(layout.shape[1]):
                if layout[i, j]:
                    ax.add_patch(
                        patches.Rectangle(
                            (tx[i, j] - ts[0], ty[i, j] - ts[1]), 2 * ts[0], 2 * ts[1],
                            facecolor='0.85', edgecolor='0.5', linewidth=0.8,
                        )
                    )

        mover_xy = np.asarray(state['mover_xy'])
        mover_vel = to_numpy(state.get('mover_vel', np.zeros_like(mover_xy)))
        goals = state.get('goals')
        m = mover_xy.shape[0]
        colors = self._mover_colors or [f'C{i}' for i in range(m)]

        c_size = to_numpy(p.c_size)
        for i in range(m):
            color = colors[i % len(colors)]
            if c_size.ndim == 1:  # circle collision shape
                ax.add_patch(patches.Circle(mover_xy[i], float(c_size[i % c_size.shape[0]]),
                                            fill=False, edgecolor=color, linestyle='--', linewidth=1.0))
            else:  # box
                half = c_size[i % c_size.shape[0]]
                ax.add_patch(patches.Rectangle(mover_xy[i] - half, 2 * half[0], 2 * half[1],
                                               fill=False, edgecolor=color, linestyle='--', linewidth=1.0))
            mover_half = to_numpy(getattr(p, 'mover_size', getattr(p, 'mover_half', np.array([[0.0775, 0.0775]]))))
            half = mover_half.reshape(-1, mover_half.shape[-1])[i % mover_half.reshape(-1, mover_half.shape[-1]).shape[0]][:2]
            ax.add_patch(patches.Rectangle(mover_xy[i] - half, 2 * half[0], 2 * half[1],
                                           facecolor=color, alpha=0.6, edgecolor='k'))
            ax.annotate(
                '', xy=mover_xy[i] + 0.2 * mover_vel[i], xytext=mover_xy[i],
                arrowprops=dict(arrowstyle='->', color='k', lw=1.2),
            )
            if goals is not None:
                g = np.asarray(goals)[i]
                ax.plot(g[0], g[1], marker='*', markersize=14, color=color, markeredgecolor='k')

        if 'object_xy' in state:
            obj = np.asarray(state['object_xy'])
            oh = to_numpy(state.get('object_half', [0.035, 0.035]))
            ax.add_patch(patches.Rectangle(obj - oh, 2 * oh[0], 2 * oh[1], facecolor='tab:red', edgecolor='k'))

        hi = to_numpy(p.grid.max_xy)
        ax.set_xlim(-0.05, hi[0] + 0.05)
        ax.set_ylim(-0.05, hi[1] + 0.05)
        ax.set_aspect('equal')
        ax.set_xlabel('x [m]')
        ax.set_ylabel('y [m]')

        if self._interactive:
            self._fig.canvas.draw_idle()
            self._fig.canvas.flush_events()
            return None
        self._fig.canvas.draw()
        buf = np.asarray(self._fig.canvas.buffer_rgba())
        return buf[:, :, :3].copy()

    def close(self):
        """Close the matplotlib figure."""
        self._plt.close(self._fig)
