"""Serving and single-device training steps of the port."""
