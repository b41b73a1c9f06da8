"""Distributed-training helpers of the port: gradient compression with
error feedback, the fault-tolerance monitors ``TrainLoop`` uses, elastic
shard assignment and the crash-restart driver (``fault``), and the
sharding hints and per-family placement policies as plain data
(``constraints``, ``policies``)."""
