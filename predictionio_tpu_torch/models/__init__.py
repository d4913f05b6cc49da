"""Engine templates of the port: recommendation, Neural-CF, sequence,
e-commerce, similar-product and universal (``controller/engine.py::TEMPLATES``)."""
