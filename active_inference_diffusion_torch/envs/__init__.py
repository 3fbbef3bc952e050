"""On-device environments of the port: the classic analytic envs, the planar
MuJoCo engine, the -v4 task semantics, and the fused collect and eval loops
(``device_envs.py``, ``planar.py``, ``mujoco_tasks.py``, ``collect_graph.py``)."""
