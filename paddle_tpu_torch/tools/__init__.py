"""Port-side copies of the JAX package's serving tools, driving
``paddle_tpu_torch``'s engines, servers, routers and fleets:

* ``serving_loadgen`` (``python -m paddle_tpu_torch.tools.serving_loadgen``):
  closed- and open-loop load, traffic shapes, per-phase SLOs, tenant
  mixes, generation traffic, in process or over HTTP;
* ``chaos`` (``python -m paddle_tpu_torch.tools.chaos``): crash, hang,
  slow, poison, paged-poison, speculation-storm, disaggregated-crash,
  hot-swap and noisy-neighbor scenarios against a live fleet.

Their in-process entry points run on the card unless given
``--device cpu`` / ``device="cpu"``.  The reference tools under
``tools/`` stay the JAX package's.
"""
