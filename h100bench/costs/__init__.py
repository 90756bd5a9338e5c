"""Each kernel's operations and bytes a call, from the shapes alone: one
module a kernel, found by name (``costs.<kernel>``)."""
