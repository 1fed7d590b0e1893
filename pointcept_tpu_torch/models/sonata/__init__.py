from .sonata import OnlineCluster, Sonata, sinkhorn_knopp

__all__ = ["OnlineCluster", "Sonata", "sinkhorn_knopp"]
