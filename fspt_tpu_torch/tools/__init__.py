"""Operator tools: image diff (a copy of fspt_tpu.tools)."""
