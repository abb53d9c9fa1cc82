"""The host control loop: the controller, its snapshots, telemetry and
exposition, and the recovery scoreboard."""
