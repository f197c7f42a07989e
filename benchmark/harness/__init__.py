"""The closed-loop frame harness."""
