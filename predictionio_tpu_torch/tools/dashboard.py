"""Dashboard: evaluation-results web UI (default :9000).

Copy of ``predictionio_tpu/tools/dashboard.py`` on the port's
``utils/http.py`` router: the index lists the evaluation instances
(``pio eval``), ``/engine_instances`` the engine instances (``pio
train``), ``/evaluation_instances/<id>`` one evaluation's results, and
``/evaluation_instances.json`` / ``/evaluation_instances/<id>.json``
the same as JSON.
"""

from __future__ import annotations

import html

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.utils.http import (
    Request,
    Response,
    ServiceThread,
    instrumented_router,
    make_server,
)

DEFAULT_PORT = 9000

_PAGE = """<!DOCTYPE html>
<html><head><title>predictionio_tpu_torch dashboard</title>
<style>
 body {{ font-family: sans-serif; margin: 2rem; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #ccc; padding: .4rem .8rem; text-align: left; }}
 pre {{ background: #f6f6f6; padding: 1rem; overflow-x: auto; }}
</style></head><body>{body}</body></html>"""


class DashboardService:
    def __init__(self):
        self.router, self.metrics = instrumented_router()
        self.router.add("GET", "/", self.handle_index)
        self.router.add("GET", "/engine_instances", self.handle_engine_instances)
        self.router.add("GET", "/evaluation_instances.json", self.handle_list_json)
        # .json route first: <instance_id> would otherwise swallow the suffix
        self.router.add(
            "GET", "/evaluation_instances/<instance_id>.json", self.handle_detail_json
        )
        self.router.add("GET", "/evaluation_instances/<instance_id>", self.handle_detail)

    def handle_index(self, request: Request) -> Response:
        rows = []
        for inst in storage.get_meta_data_evaluation_instances().get_all():
            rows.append(
                f"<tr><td><a href='/evaluation_instances/{inst.id}'>{inst.id[:12]}</a></td>"
                f"<td>{html.escape(inst.evaluation_class)}</td>"
                f"<td>{inst.status}</td>"
                f"<td>{inst.start_time:%Y-%m-%d %H:%M:%S}</td>"
                f"<td>{inst.end_time:%Y-%m-%d %H:%M:%S}</td></tr>"
                if inst.end_time
                else f"<tr><td>{inst.id[:12]}</td>"
                f"<td>{html.escape(inst.evaluation_class)}</td>"
                f"<td>{inst.status}</td>"
                f"<td>{inst.start_time:%Y-%m-%d %H:%M:%S}</td><td>-</td></tr>"
            )
        body = (
            "<h1>Evaluation Instances</h1>"
            "<p><a href='/engine_instances'>engine instances</a></p>"
            "<table><tr><th>ID</th><th>Evaluation</th><th>Status</th>"
            "<th>Start</th><th>End</th></tr>" + "".join(rows) + "</table>"
        )
        return Response(200, _PAGE.format(body=body), content_type="text/html; charset=utf-8")

    def handle_engine_instances(self, request: Request) -> Response:
        rows = [
            f"<tr><td>{inst.id[:12]}</td><td>{html.escape(inst.engine_factory)}</td>"
            f"<td>{inst.status}</td><td>{inst.start_time:%Y-%m-%d %H:%M:%S}</td></tr>"
            for inst in storage.get_meta_data_engine_instances().get_all()
        ]
        body = (
            "<h1>Engine Instances</h1><p><a href='/'>back</a></p>"
            "<table><tr><th>ID</th><th>Factory</th><th>Status</th><th>Start</th></tr>"
            + "".join(rows)
            + "</table>"
        )
        return Response(200, _PAGE.format(body=body), content_type="text/html; charset=utf-8")

    def handle_list_json(self, request: Request) -> Response:
        out = [
            {
                "id": inst.id,
                "evaluationClass": inst.evaluation_class,
                "status": inst.status,
                "startTime": inst.start_time.isoformat(),
                "endTime": inst.end_time.isoformat() if inst.end_time else None,
            }
            for inst in storage.get_meta_data_evaluation_instances().get_all()
        ]
        return Response(200, out)

    def _get(self, instance_id: str):
        return storage.get_meta_data_evaluation_instances().get(instance_id)

    def handle_detail(self, request: Request) -> Response:
        inst = self._get(request.path_params["instance_id"])
        if inst is None:
            return Response(404, _PAGE.format(body="<h1>not found</h1>"),
                            content_type="text/html; charset=utf-8")
        body = (
            f"<h1>Evaluation {inst.id[:12]}</h1><p><a href='/'>back</a></p>"
            f"<p>class: {html.escape(inst.evaluation_class)} | status: {inst.status}</p>"
            + (inst.evaluator_results_html or "<p>(no results)</p>")
        )
        return Response(200, _PAGE.format(body=body), content_type="text/html; charset=utf-8")

    def handle_detail_json(self, request: Request) -> Response:
        inst = self._get(request.path_params["instance_id"])
        if inst is None:
            return Response(404, {"message": "not found"})
        return Response(
            200,
            {
                "id": inst.id,
                "status": inst.status,
                "results": inst.evaluator_results,
                "resultsJson": inst.evaluator_results_json,
            },
        )


def create_dashboard(host: str = "0.0.0.0", port: int = DEFAULT_PORT) -> ServiceThread:
    service = DashboardService()
    return ServiceThread(make_server(service.router, host, port, "pio-dashboard"))


def run_dashboard(host: str = "0.0.0.0", port: int = DEFAULT_PORT) -> None:
    thread = create_dashboard(host, port)
    print(f"Dashboard listening on http://{host}:{port}")
    thread.server.serve_forever()
