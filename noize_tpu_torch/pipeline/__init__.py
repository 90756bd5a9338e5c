"""Stage protocol, concrete stages and the work-queue executor."""
