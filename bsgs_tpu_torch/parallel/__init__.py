"""Several cards: one process per card, joined by ``torch.distributed``.

Counterpart of ``bsgs_tpu/parallel``. ``mesh`` joins the ranks (NCCL on
cards, gloo on the CPU), ``striped.MeshSolver`` stripes the scan over them
in super-epochs, and ``sharded_table`` probes a baby table split by bucket
range over them. Every rank holds the same hit records and makes the same
decisions in the same order, so the ranks' collectives stay matched.
"""
