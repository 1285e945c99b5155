"""Fleet serving: a router in front of many engine gateways.

``python -m heat_tpu_torch fleet`` runs a stdlib-HTTP router
(``router.py``) over a :class:`~.registry.BackendRegistry` of independent
``serve --listen`` processes, each with its own scheduler thread and
interpreter lock in front of the card. Placement is a pure policy
(``placement.py``) over each backend's ``GET /v1/status`` payload —
least-loaded by predicted backlog seconds, burn-aware demotion,
mega-capability routing — and rebalancing is work stealing as a
checkpoint handoff: drain a loaded backend to its engine manifest, resume
it on an idle one, the same bytes across the migration. The contracts are
``heat_tpu.fleet``'s.

Import the pieces from their modules (``fleet.router``,
``fleet.registry``, ``fleet.placement``, ``fleet.resilience``): this
package init stays import-light, so ``fleet.placement`` loads neither the
HTTP stack nor torch.
"""
