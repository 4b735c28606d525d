from .heartbeat import Heartbeat, read_heartbeats, stale_hosts
from .straggler import StragglerMonitor
from .supervisor import Supervisor, plan_remesh

__all__ = ["Heartbeat", "read_heartbeats", "stale_hosts",
           "StragglerMonitor", "Supervisor", "plan_remesh"]
