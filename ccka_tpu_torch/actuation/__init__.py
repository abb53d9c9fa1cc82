"""Actuation: rendering decisions into cluster mutations and applying them
(NodePool patches, HPA and KEDA manifests, sinks, reconciliation, chaos)."""
