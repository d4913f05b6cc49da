"""Engine templates of the port: recommendation, Neural-CF, sequence,
e-commerce, similar-product, universal and classification
(each package's ``engine_factory``, ``workflow/json_extractor.py::
TEMPLATES``), and e2's building blocks
(``models/e2.py``)."""
