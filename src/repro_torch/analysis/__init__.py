"""The dry-run's analysis: aten-op cost of a fake trace (``op_cost``), an
H100 roofline (``roofline``) and the records' table (``report``)."""
