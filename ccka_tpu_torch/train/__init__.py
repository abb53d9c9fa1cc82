"""Learned backends: checkpoints, the PPO policy backend and the shipped
flagship policies."""
