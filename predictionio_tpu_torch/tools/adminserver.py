"""Admin server: REST mirror of the app/accesskey CLI (default :7071).

Copy of ``predictionio_tpu/tools/adminserver.py`` on the port's
``utils/http.py`` router and ``tools/app_ops.py``. Routes:

- ``GET  /``                      server info
- ``GET  /cmd/app``               list apps
- ``POST /cmd/app``               create app {name, description?}
- ``GET  /cmd/app/<name>``        app details
- ``DELETE /cmd/app/<name>``      delete app + data
- ``DELETE /cmd/app/<name>/data`` wipe event data
"""

from __future__ import annotations

import json

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.utils.http import (
    Request,
    Response,
    ServiceThread,
    instrumented_router,
    make_server,
)

DEFAULT_PORT = 7071


class AdminService:
    def __init__(self):
        self.router, self.metrics = instrumented_router()
        self.router.add("GET", "/", self.handle_info)
        self.router.add("GET", "/cmd/app", self.handle_list)
        self.router.add("POST", "/cmd/app", self.handle_create)
        self.router.add("GET", "/cmd/app/<name>", self.handle_show)
        self.router.add("DELETE", "/cmd/app/<name>", self.handle_delete)
        self.router.add("DELETE", "/cmd/app/<name>/data", self.handle_data_delete)

    def handle_info(self, request: Request) -> Response:
        from predictionio_tpu_torch.version import __version__

        return Response(200, {"status": "alive", "version": __version__})

    def handle_list(self, request: Request) -> Response:
        keys = storage.get_meta_data_access_keys()
        return Response(
            200,
            [
                {
                    "name": app.name,
                    "id": app.id,
                    "description": app.description,
                    "accessKeys": [k.key for k in keys.get_by_app_id(app.id)],
                }
                for app in storage.get_meta_data_apps().get_all()
            ],
        )

    def handle_create(self, request: Request) -> Response:
        from predictionio_tpu_torch.tools.app_ops import create_app

        try:
            body = request.json() or {}
        except json.JSONDecodeError:
            return Response(400, {"message": "malformed JSON body"})
        name = body.get("name")
        if not name:
            return Response(400, {"message": "field 'name' is required"})
        try:
            app, key = create_app(name, body.get("description", ""))
        except ValueError as exc:
            return Response(409, {"message": str(exc)})
        return Response(201, {"name": name, "id": app.id, "accessKey": key})

    def _app(self, request: Request):
        return storage.get_meta_data_apps().get_by_name(request.path_params["name"])

    def handle_show(self, request: Request) -> Response:
        app = self._app(request)
        if app is None:
            return Response(404, {"message": "app not found"})
        keys = storage.get_meta_data_access_keys().get_by_app_id(app.id)
        channels = storage.get_meta_data_channels().get_by_app(app.id)
        return Response(
            200,
            {
                "name": app.name,
                "id": app.id,
                "description": app.description,
                "accessKeys": [{"key": k.key, "events": k.events} for k in keys],
                "channels": [{"name": c.name, "id": c.id} for c in channels],
            },
        )

    def handle_delete(self, request: Request) -> Response:
        from predictionio_tpu_torch.tools.app_ops import delete_app_cascade

        app = self._app(request)
        if app is None:
            return Response(404, {"message": "app not found"})
        delete_app_cascade(app)
        return Response(200, {"message": f"app {app.name!r} deleted"})

    def handle_data_delete(self, request: Request) -> Response:
        from predictionio_tpu_torch.tools.app_ops import delete_app_data

        app = self._app(request)
        if app is None:
            return Response(404, {"message": "app not found"})
        # REST wipe covers every channel (matches its 'wipe event data' doc)
        delete_app_data(app, all_channels=True)
        return Response(200, {"message": "event data deleted"})


def create_admin_server(host: str = "0.0.0.0", port: int = DEFAULT_PORT) -> ServiceThread:
    service = AdminService()
    return ServiceThread(make_server(service.router, host, port, "pio-adminserver"))


def run_admin_server(host: str = "0.0.0.0", port: int = DEFAULT_PORT) -> None:
    thread = create_admin_server(host, port)
    print(f"Admin server listening on http://{host}:{port}")
    thread.server.serve_forever()
