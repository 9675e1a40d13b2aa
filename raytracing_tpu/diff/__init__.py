"""Differentiable rendering: FD oracle + edge-aware gradients.

Two tiers of gradients:

1. PRODUCTION, interior-exact: XLA's AD of the hard stage pipeline
   (`render.pathtracer._render_pass`, sharded by
   `parallel.mesh.make_train_step`). The champion search runs under
   stop_gradient and hit points are recomputed from gathered object
   parameters, so cotangents follow the hard champion `where` — exact
   wherever visibility is locally constant (almost everywhere), silent
   exactly at silhouettes.

2. Edge-aware soft renderers (this package): `soft.render_fake_shade_soft`,
   `soft.render_direct_soft`, `soft.render_pathtrace_soft` — soft forward
   AND backward (sigmoid silhouette coverage, softmin depth, soft shadow
   transmittance), so visibility gradients at silhouettes and shadow
   boundaries are real. They converge to the hard pipeline as the
   bandwidth goes to 0 (tested). `fd.finite_difference` / `fd.check_grad`
   are the FD harness every gradient claim is tested against.

Choosing a bandwidth: it is the silhouette smoothing width in SCENE
units; ~1e-2 x scene scale gives a few pixels of support at 512-1024 px
renders. Anneal toward 0 during optimization for a sharp endpoint
(examples/silhouette_optim.py).
"""
from .fd import check_grad, finite_difference  # noqa: F401
