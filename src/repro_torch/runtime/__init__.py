"""Runtime substrate of the port: the elastic cluster controller and the
straggler monitor."""
from .elastic import ElasticCluster, StragglerMonitor

__all__ = ["ElasticCluster", "StragglerMonitor"]
