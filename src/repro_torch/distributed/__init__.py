"""Distributed-training helpers of the port: gradient compression with
error feedback and the fault-tolerance monitors ``TrainLoop`` uses."""
