"""Engine templates of the port: recommendation, Neural-CF, sequence,
e-commerce, similar-product, universal and classification
(``controller/engine.py::TEMPLATES``), and e2's building blocks
(``models/e2.py``)."""
