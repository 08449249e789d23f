"""Step and eval runners (``multistep.py``), the (member, data) grid of
ranks on ``torch.distributed`` (``mesh.py``) and the data- and
member-parallel trainer (``pipelines.py``). The package imports none of
them: ``utils/optim.py`` reads the active mesh, and the runners import the
noise sources, which import the optimizers' users."""
