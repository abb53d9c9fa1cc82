"""The cluster simulator: types, dynamics, metrics, rollouts and the
rollout kernels' host side."""
