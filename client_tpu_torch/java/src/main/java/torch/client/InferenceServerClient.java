// HTTP client for the v2 inference protocol with the binary-tensor
// extension. Parity: ref src/java/.../InferenceServerClient.java surface,
// re-designed on java.net.http.HttpClient.
package torch.client;

import java.io.ByteArrayOutputStream;
import java.io.IOException;
import java.net.URI;
import java.net.http.HttpClient;
import java.net.http.HttpRequest;
import java.net.http.HttpResponse;
import java.nio.charset.StandardCharsets;
import java.time.Duration;
import java.util.List;

import torch.client.endpoint.AbstractEndpoint;
import torch.client.endpoint.FixedEndpoint;

public class InferenceServerClient implements AutoCloseable {
  private final HttpClient http;
  private final AbstractEndpoint endpoint;
  private final Duration requestTimeout;
  private final int retryCnt;

  public InferenceServerClient(String url) {
    this(new FixedEndpoint(url), HttpConfig.defaults());
  }

  public InferenceServerClient(String url, Duration connectTimeout,
                               Duration requestTimeout) {
    this(new FixedEndpoint(url),
         HttpConfig.defaults()
             .connectTimeout(connectTimeout)
             .requestTimeout(requestTimeout));
  }

  public InferenceServerClient(String url, HttpConfig config) {
    this(new FixedEndpoint(url), config);
  }

  /** Endpoint-abstraction constructor: each request targets
   *  endpoint.next(), enabling client-side load balancing
   *  (parity: ref endpoint/ + InferenceServerClient.java:76-231). */
  public InferenceServerClient(AbstractEndpoint endpoint,
                               HttpConfig config) {
    this.endpoint = endpoint;
    this.requestTimeout = config.getRequestTimeout();
    this.retryCnt = config.getRetryCnt();
    this.http = HttpClient.newBuilder()
                    .connectTimeout(config.getConnectTimeout())
                    .build();
  }

  // ---- health / metadata ----

  public boolean isServerLive() throws InferenceException {
    return get("/v2/health/live").statusCode() == 200;
  }

  public boolean isServerReady() throws InferenceException {
    return get("/v2/health/ready").statusCode() == 200;
  }

  public boolean isModelReady(String model) throws InferenceException {
    return get("/v2/models/" + model + "/ready").statusCode() == 200;
  }

  public Json serverMetadata() throws InferenceException {
    return jsonOf(checkOk(get("/v2")));
  }

  public Json modelMetadata(String model) throws InferenceException {
    return jsonOf(checkOk(get("/v2/models/" + model)));
  }

  public Json modelConfig(String model) throws InferenceException {
    return jsonOf(checkOk(get("/v2/models/" + model + "/config")));
  }

  public Json inferenceStatistics(String model) throws InferenceException {
    return jsonOf(checkOk(get("/v2/models/" + model + "/stats")));
  }

  public void loadModel(String model) throws InferenceException {
    checkOk(post("/v2/repository/models/" + model + "/load", new byte[0],
                 null));
  }

  public void unloadModel(String model) throws InferenceException {
    checkOk(post("/v2/repository/models/" + model + "/unload", new byte[0],
                 null));
  }

  // ---- shared memory verbs ----

  public void registerSystemSharedMemory(String name, String key,
                                         long byteSize)
      throws InferenceException {
    Json req = Json.object()
                   .put("key", Json.of(key))
                   .put("offset", Json.of(0L))
                   .put("byte_size", Json.of(byteSize));
    checkOk(post("/v2/systemsharedmemory/region/" + name + "/register",
                 req.dump().getBytes(StandardCharsets.UTF_8), null));
  }

  /** Registers a CUDA shared-memory region: ``rawHandleB64`` is the
   *  base64 of the region's raw handle (the port's Python
   *  ``cuda_shared_memory.get_raw_handle`` makes one). */
  public void registerCudaSharedMemory(String name, String rawHandleB64,
                                       int deviceId, long byteSize)
      throws InferenceException {
    Json req = Json.object()
                   .put("raw_handle",
                        Json.object().put("b64", Json.of(rawHandleB64)))
                   .put("device_id", Json.of((long) deviceId))
                   .put("byte_size", Json.of(byteSize));
    checkOk(post("/v2/cudasharedmemory/region/" + name + "/register",
                 req.dump().getBytes(StandardCharsets.UTF_8), null));
  }

  public void unregisterSystemSharedMemory(String name)
      throws InferenceException {
    String path = name == null || name.isEmpty()
                      ? "/v2/systemsharedmemory/unregister"
                      : "/v2/systemsharedmemory/region/" + name
                            + "/unregister";
    checkOk(post(path, new byte[0], null));
  }

  public void unregisterCudaSharedMemory(String name)
      throws InferenceException {
    String path = name == null || name.isEmpty()
                      ? "/v2/cudasharedmemory/unregister"
                      : "/v2/cudasharedmemory/region/" + name
                            + "/unregister";
    checkOk(post(path, new byte[0], null));
  }

  // ---- inference ----

  public InferResult infer(String model, List<InferInput> inputs,
                           List<InferRequestedOutput> outputs)
      throws InferenceException {
    Json req = Json.object();
    Json jin = Json.array();
    for (InferInput input : inputs) jin.add(input.toJson());
    req.put("inputs", jin);
    if (outputs != null && !outputs.isEmpty()) {
      Json jout = Json.array();
      for (InferRequestedOutput out : outputs) jout.add(out.toJson());
      req.put("outputs", jout);
    }
    byte[] header = req.dump().getBytes(StandardCharsets.UTF_8);
    ByteArrayOutputStream body = new ByteArrayOutputStream();
    body.writeBytes(header);
    for (InferInput input : inputs) {
      if (!input.isSharedMemory()) body.writeBytes(input.binaryData());
    }

    HttpResponse<byte[]> resp =
        post("/v2/models/" + model + "/infer", body.toByteArray(),
             String.valueOf(header.length));
    int headerLength = resp.headers()
                           .firstValue("Inference-Header-Content-Length")
                           .map(Integer::parseInt)
                           .orElse(0);
    if (resp.statusCode() != 200) {
      String msg = new String(resp.body(), StandardCharsets.UTF_8);
      try {
        msg = Json.parse(msg).at("error").asString();
      } catch (RuntimeException ignored) {
        // keep raw body as message
      }
      throw new InferenceException(msg, resp.statusCode());
    }
    return new InferResult(resp.body(), headerLength);
  }

  @Override
  public void close() {}

  // ---- transport ----

  private HttpResponse<byte[]> get(String path) throws InferenceException {
    return withRetries(() -> {
      HttpRequest req =
          HttpRequest.newBuilder(URI.create(endpoint.next() + path))
              .timeout(requestTimeout)
              .GET()
              .build();
      return http.send(req, HttpResponse.BodyHandlers.ofByteArray());
    });
  }

  private HttpResponse<byte[]> post(String path, byte[] body,
                                    String inferHeaderLength)
      throws InferenceException {
    return withRetries(() -> {
      HttpRequest.Builder b =
          HttpRequest.newBuilder(URI.create(endpoint.next() + path))
              .timeout(requestTimeout)
              .POST(HttpRequest.BodyPublishers.ofByteArray(body));
      if (inferHeaderLength != null) {
        b.header("Inference-Header-Content-Length", inferHeaderLength);
        b.header("Content-Type", "application/octet-stream");
      } else {
        b.header("Content-Type", "application/json");
      }
      return http.send(b.build(), HttpResponse.BodyHandlers.ofByteArray());
    });
  }

  private interface Transport {
    HttpResponse<byte[]> send() throws IOException, InterruptedException;
  }

  /** Connection-level failures retry up to retryCnt times; an HTTP
   *  status is final (parity: ref retry loop
   *  InferenceServerClient.java:228-330). With a multi-endpoint
   *  abstraction each attempt may land on a different replica. */
  private HttpResponse<byte[]> withRetries(Transport t)
      throws InferenceException {
    IOException last = null;
    for (int attempt = 0; attempt <= retryCnt; ++attempt) {
      try {
        return t.send();
      } catch (IOException e) {
        last = e;
      } catch (InterruptedException e) {
        Thread.currentThread().interrupt();
        throw new InferenceException("request interrupted");
      }
    }
    throw new InferenceException(
        "request failed after " + (retryCnt + 1) + " attempt(s): "
        + (last == null ? "unknown" : last.getMessage()));
  }

  private HttpResponse<byte[]> checkOk(HttpResponse<byte[]> resp)
      throws InferenceException {
    if (resp.statusCode() != 200) {
      throw new InferenceException(
          new String(resp.body(), StandardCharsets.UTF_8),
          resp.statusCode());
    }
    return resp;
  }

  private static Json jsonOf(HttpResponse<byte[]> resp)
      throws InferenceException {
    try {
      return Json.parse(new String(resp.body(), StandardCharsets.UTF_8));
    } catch (RuntimeException e) {
      throw new InferenceException("bad JSON response: " + e.getMessage());
    }
  }
}
