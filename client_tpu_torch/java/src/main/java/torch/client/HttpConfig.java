// Transport knobs for the Java client.
// Parity: ref src/java/.../InferenceServerClient.java:76-231 HttpConfig
// (io threads / timeouts / keep-alive / retryCnt) — re-designed on
// java.net.http.HttpClient, which owns its own reactor threads, so the
// surviving knobs are the timeouts, the retry count, and HTTP version.
package torch.client;

import java.time.Duration;

public class HttpConfig {
  private Duration connectTimeout = Duration.ofSeconds(60);
  private Duration requestTimeout = Duration.ofSeconds(60);
  private int retryCnt = 0;

  public static HttpConfig defaults() {
    return new HttpConfig();
  }

  public HttpConfig connectTimeout(Duration d) {
    this.connectTimeout = d;
    return this;
  }

  public HttpConfig requestTimeout(Duration d) {
    this.requestTimeout = d;
    return this;
  }

  /** Transparent retries of transport-level failures (parity:
   *  ref setRetryCnt / the retry loop at InferenceServerClient.java:228).
   *  Only connection errors are retried; an HTTP error status is final
   *  (the request reached the server). */
  public HttpConfig retryCnt(int n) {
    this.retryCnt = Math.max(0, n);
    return this;
  }

  public Duration getConnectTimeout() {
    return connectTimeout;
  }

  public Duration getRequestTimeout() {
    return requestTimeout;
  }

  public int getRetryCnt() {
    return retryCnt;
  }
}
