"""Governance: the module account name, which the crisis invariants and the
proposal messages read.

The port's copy of that constant of celestia_app_tpu/modules/gov.py; the
proposal lifecycle (GovKeeper) comes with the message handlers and the end
blocker (ROADMAP, queue 1).
"""

GOV_MODULE = "gov"  # escrow account for deposits
