"""Data-parallel, FSDP and tensor-parallel work over ``torch.distributed``
(counterpart of ``tts_max_tpu/parallel``): the launcher's rendezvous and the
``(data, fsdp, tensor)`` mesh (``mesh.py``), the partition rules and the
shards they give (``sharding.py``), the counted collectives
(``collectives.py``), the tensor-parallel plan of the Llama layers
(``tensor.py``) and the per-process batch rule and barrier
(``multihost.py``)."""
