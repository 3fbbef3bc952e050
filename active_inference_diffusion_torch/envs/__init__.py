"""On-device environments of the port: the classic analytic envs, the planar
and the 3D MuJoCo engines, the -v4 task semantics, and the fused collect and
eval loops (``device_envs.py``, ``planar.py``, ``rigid3d.py``,
``mujoco_tasks.py``, ``collect_graph.py``)."""
